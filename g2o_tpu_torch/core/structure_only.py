"""Structure-only BA refinement — port of ``g2o_tpu/core/structure_only.py``,
the analogue of the reference ``StructureOnlySolver``
(``g2o/solvers/structure_only/structure_only_solver.h:57``): optimize
landmark positions with all poses frozen.

The reference loops over landmarks, running an independent little LM with
``solveDirect`` per point.  Here ALL landmarks run their LM at once: the
per-landmark Hessian blocks, gradients and chi2 come from ``index_add_``
over the observation rows, the ``(H_jj + λ_j I)⁻¹ b_j`` solves are one
batched ``torch.linalg.solve`` on ``(N, d, d)``, and each landmark carries
its own ``(λ_j, ν_j)`` trust-region state with per-landmark accept masks.
A Python loop over ``n_iters`` takes the place of the JAX package's
``lax.fori_loop``; it reads nothing from the device.  On sharded data
(``ProblemData.group``) the per-landmark sums over this process's
observation rows are completed by one all-reduce per evaluation.
"""

from __future__ import annotations

import torch

from g2o_tpu_torch.core.problem import edge_sum_, residuals_and_jacobians


def structure_only_refine(problem, n_iters: int = 10, *,
                          initial_lambda: float = 1e-4):
    """Refine marginalized landmarks in place; returns
    ``{type: (chi2_before (N,), chi2_after (N,))}`` per landmark type, as
    host numpy arrays."""
    p = problem
    lm_types = [t for t, m in p.marginalized.items() if m.all()]
    if not lm_types:
        raise ValueError("structure_only: no marginalized landmark vertices")

    # observation edge types touching each landmark type
    obs_by_type = {t: [] for t in lm_types}
    for name, et in p.edge_types.items():
        for s, vt in enumerate(et.vertex_types):
            if vt.name in obs_by_type:
                obs_by_type[vt.name].append((name, s))

    def per_landmark_quantities(estimates, t, d, need_hb=True):
        """(H (N,d,d), b (N,d), chi2 (N,)) for landmark type t."""
        N = p.counts[t]
        H = torch.zeros((N, d, d), dtype=p.dtype, device=p.device)
        b = torch.zeros((N, d), dtype=p.dtype, device=p.device)
        chi = torch.zeros((N,), dtype=p.dtype, device=p.device)
        for name, s in obs_by_type[t]:
            et = p.edge_types[name]
            batch = p.data.edges[name]
            states = p._states(et, batch, estimates)
            if need_hb:
                e, Js = residuals_and_jacobians(et, states, batch.meas,
                                                batch.param)
            else:
                e = et.residual(states, batch.meas, batch.param)
            e2 = torch.einsum("er,ers,es->e", e, batch.info, e)
            rho = p._robustify(name, batch, e2)
            act = batch.active.to(p.dtype)
            idx = batch.vidx[:, s]
            chi.index_add_(0, idx, rho[:, 0] * act)
            if need_hb:
                W = batch.info * (rho[:, 1] * act)[:, None, None]
                Jl = Js[s]
                H.index_add_(0, idx,
                             torch.einsum("erd,ers,esf->edf", Jl, W, Jl))
                b.index_add_(0, idx,
                             -torch.einsum("erd,ers,es->ed", Jl, W, e))
        edge_sum_(p.data, *((H, b, chi) if need_hb else (chi,)))
        return H, b, chi

    results = {}
    for t in lm_types:
        vt = p.vertex_types[t]
        d = vt.tangent_dim
        N = p.counts[t]
        eye = torch.eye(d, dtype=p.dtype, device=p.device)
        fixed = p.data.fixed[t].to(p.dtype)[:, None]
        fx3 = fixed[:, :, None]
        estimates = dict(p.estimates)
        lam = torch.full((N,), initial_lambda, dtype=p.dtype,
                         device=p.device)
        ni = torch.full((N,), 2.0, dtype=p.dtype, device=p.device)
        _, _, chi_before = per_landmark_quantities(estimates, t, d,
                                                   need_hb=False)
        for _ in range(n_iters):
            H, b, chi0 = per_landmark_quantities(estimates, t, d)
            Hl = H + lam[:, None, None] * eye
            Hl = Hl * (1.0 - fx3) + eye * fx3
            dx = torch.linalg.solve(Hl, b[..., None])[..., 0]
            dx = dx * (1.0 - fixed)
            cand_t = vt.oplus(estimates[t], dx)
            cand = dict(estimates)
            cand[t] = cand_t
            _, _, chi1 = per_landmark_quantities(cand, t, d, need_hb=False)
            scale = torch.einsum("nd,nd->n", dx, lam[:, None] * dx + b) + 1e-3
            rho = (chi0 - chi1) / scale
            ok = torch.isfinite(chi1) & (rho > 0) & (chi1 < chi0)
            factor = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3,
                                 min=1.0 / 3.0)
            lam = torch.where(ok, lam * factor, lam * ni)
            ni = torch.where(ok, torch.full_like(ni, 2.0), ni * 2.0)
            estimates[t] = torch.where(ok[:, None], cand_t, estimates[t])
        _, _, chi_after = per_landmark_quantities(estimates, t, d,
                                                  need_hb=False)
        p.set_estimates(estimates)
        results[t] = (chi_before.cpu().numpy(), chi_after.cpu().numpy())
    return results
