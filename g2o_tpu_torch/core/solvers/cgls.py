"""Square-root CGLS solver — port of ``g2o_tpu/core/solvers/cgls.py``, the
fork's ``JacobiSolver`` + ``LinearSolverPCGEigen`` pair
(``g2o/core/jacobi_solver.hpp:480-697``,
``g2o/solvers/eigen/linear_solver_pcg_eigen.h:33-502``).

Instead of assembling the Hessian, CG iterates on the damped least-squares
system

    min_x || [sqrt(W) J; sqrt(λ) I] x  −  [sqrt(W) e; 0] ||²

with ``W = ρ'·Ω``.  The whitened Jacobian exists only as the cached
per-edge blocks: ``J p`` and ``Jᵀ r`` are batched products and segment
sums, and the damping rows are the closed-form terms ``sqrt(λ) p`` and
``−λ x``.  ``sqrt(W)`` is the lower Cholesky factor ``L`` of each edge's
``W`` (``chol_small``), with a jitter on each zero diagonal entry; ``Jmat``
applies ``Lᵀ`` and ``Jt`` its adjoint ``L``.  The preconditioner is the
block-Jacobi ``(H_ii + λI)⁻¹`` (identity on fixed vertices), the
algebraic equivalent of the fork's per-vertex thin-QR factors.  CG stops at
the fork's η-forcing bound ``γ ≤ η·γ₀``
(``linear_solver_pcg_eigen.h:184-188``) or after ``max_iter`` iterations,
reading ``γ`` on the host once per iteration.

A landmark-bucketed batch (``Problem.bucket_specs``) keeps the problem's
DIMS-MAJOR leaves, ``(r, d, E)``, through the CG loop: its landmark slot is
a dense product per degree slab (the landmark value broadcast over the
slab's degree axis), and its camera slot is read with the dims-major
gather (``onehot_gather_t``) and summed with the dims-major segment sum
(``onehot_scatter_add_t``) — on a CUDA tensor the hand-written kernels of
``csrc/gather_segment.cu`` (K5/K6), once each per CG iteration.  Every
other batch gathers with ``index_select`` and sums with ``index_add_``.
``onehot_max_segments`` (the JAX package's TPU routing) is accepted and
ignored; ``matvec_precision`` is validated and has no effect (TF32 is off
package-wide).  On sharded data (``ProblemData.group``) each ``‖J p‖²``
and ``Jᵀ r`` over this process's edge rows is completed by one
all-reduce.  A process holds one contiguous window of a bucketed batch's
slab rows: its landmark values are read from the slab broadcast cut to
that window, and its landmark sums sit at their places in a zeroed
full-width slab buffer before the per-slab sums, so the all-reduce of
``Jᵀ r`` completes them with the camera sums.
"""

from __future__ import annotations

import torch

from g2o_tpu_torch.core.problem import edge_sum_, row_window
from g2o_tpu_torch.ops.bucketed import slab_broadcast_t, slab_sum_t
from g2o_tpu_torch.ops.onehot import onehot_gather_t, onehot_scatter_add_t
from g2o_tpu_torch.ops.smallblocks import chol_small, inv_small


class CGLSSolver:
    name = "cgls"

    def __init__(self, max_iter: int = 200, eta: float = 1e-4,
                 onehot_max_segments: int = 8192,
                 matvec_precision: str = "default"):
        self.max_iter = int(max_iter)
        # the fork's bound |s|² <= eta·|s_0|² (linear_solver_pcg_eigen.h:184)
        self.eta = float(eta)
        if matvec_precision not in ("default", "highest"):
            raise ValueError(f"unknown matvec_precision {matvec_precision!r}")
        self.matvec_precision = matvec_precision
        self.onehot_max_segments = int(onehot_max_segments)
        self.aux = ()
        self._solve_fn = None
        self._setup_for = None
        # CG iterations of the solves so far (a count, read by benchmarks)
        self.solves = 0
        self.cg_iterations = 0

    def setup(self, problem, force: bool = False):
        """Bind the solve to ``problem`` (a no-op when called again for the
        same problem)."""
        if self._setup_for is problem and not force:
            return self
        p = problem
        max_iter, eta = self.max_iter, self.eta
        dtype, dev = p.dtype, p.device
        specs = p.bucket_specs

        def window(data, name):
            """``(lo, m)``: this process holds slab rows ``[lo, lo + m)`` of
            bucketed batch ``name`` as its first ``m`` rows (all of them
            unsharded); any rows past them are the pad-to-multiple tail."""
            lo, n = row_window(data, name)
            return lo, max(0, min(n, specs[name].n_rows - lo))

        def slab_sums(data, name, z):
            """Per-row ``(k, m)`` of the window -> per-landmark ``(k,
            S_used)`` sums in bucket order: sharded, the rows sit at their
            places in a zeroed full-width slab buffer (this process's
            partial sums); each degree-major slab is a ``(k, deg, n)`` view
            summed over deg."""
            spec = specs[name]
            lo, m = window(data, name)
            if m != spec.n_rows:
                zf = z.new_zeros((z.shape[0], spec.n_rows))
                zf[:, lo:lo + m] = z
                z = zf
            return slab_sum_t(spec.counts, spec.degrees, z)

        def whiten(lin):
            """Per edge type the lower Cholesky factor of W: ``(E, r, r)``,
            or ``(r, r, E)`` on a bucketed batch.  W may be rank-deficient
            (inactive edges, disabled residual components), so each zero
            DIAGONAL ENTRY gets a 1e-30 jitter and ``chol_small`` never
            takes the root of a negative number."""
            Ls = {}
            for name in p.edge_types:
                W = p.edge_weights(lin, name)
                r = W.shape[-1]
                eye = torch.eye(r, dtype=dtype, device=dev)
                dg = torch.diagonal(W, dim1=-2, dim2=-1).abs()     # (E, r)
                jitter = (dg < 1e-30).to(dtype) * 1e-30
                L = chol_small(W + eye * jitter[:, :, None])
                Ls[name] = (L.permute(1, 2, 0).contiguous()
                            if name in specs else L)
            return Ls

        def landmark_values(data, name, spec, vb_t):
            """The bucket-order landmark rows of batch ``name``."""
            if spec.seg_identity:
                return vb_t[:sum(spec.counts)]
            return vb_t[data.plans[name]["segp"]]

        def Jmat(data, lin, Ls, vb):
            """``u = sqrt(W) J v`` per edge type: ``(E, r)``, dims-major
            ``(r, E)`` on a bucketed batch."""
            out = {}
            for name, et in p.edge_types.items():
                spec = specs.get(name)
                if spec is None:
                    vidx = data.edges[name].vidx
                    Js = lin.jacs[name]
                    y = None
                    for s, vt in enumerate(et.vertex_types):
                        rows = vb[vt.name].index_select(0, vidx[:, s])
                        ys = torch.einsum("erd,ed->er", Js[s], rows)
                        y = ys if y is None else y + ys
                    out[name] = torch.einsum("esr,es->er", Ls[name], y)
                    continue
                Jd = lin.jacs[name]                       # (r, d_s, E)
                ps, ls = spec.pose_slot, spec.lm_slot
                E = Jd[ls].shape[-1]
                ids = data.plans[name]["ids32"][ps]
                rows_t = onehot_gather_t(ids, vb[et.vertex_types[ps].name])
                y = torch.sum(Jd[ps] * rows_t[None], dim=1)      # (r, E)
                # the landmark slot: each slab row's landmark value
                lo, m = window(data, name)
                v_rows = slab_broadcast_t(
                    spec.counts, spec.degrees, landmark_values(
                        data, name, spec, vb[et.vertex_types[ls].name]).T)
                yl = torch.sum(Jd[ls][:, :, :m] * v_rows[None, :, lo:lo + m],
                               dim=1)                             # (r, m)
                if E > m:                 # pad-to-multiple tail: J == 0
                    yl = torch.cat([yl, yl.new_zeros((yl.shape[0], E - m))],
                                   dim=1)
                y = y + yl
                # u[r, e] = Σ_s L[s, r, e] y[s, e]  (Lᵀ y)
                out[name] = torch.sum(Ls[name] * y[:, None, :], dim=0)
            return out

        def Jt(data, lin, Ls, u):
            """``v = Jᵀ sqrt(W)ᵀ u`` in block layout: the adjoint of
            :func:`Jmat`, ``z = L u`` (never ``Lᵀ u``: a non-diagonal
            information matrix would give the wrong step)."""
            out = {t: torch.zeros((p.counts[t], vt.tangent_dim), dtype=dtype,
                                  device=dev)
                   for t, vt in p.vertex_types.items()}
            for name, et in p.edge_types.items():
                spec = specs.get(name)
                if spec is None:
                    vidx = data.edges[name].vidx
                    Js = lin.jacs[name]
                    z = torch.einsum("esr,er->es", Ls[name], u[name])
                    for s, vt in enumerate(et.vertex_types):
                        out[vt.name].index_add_(
                            0, vidx[:, s], torch.einsum("erd,er->ed",
                                                        Js[s], z))
                    continue
                Jd = lin.jacs[name]
                ps, ls = spec.pose_slot, spec.lm_slot
                pt, lt = et.vertex_types[ps].name, et.vertex_types[ls].name
                # z[s, e] = Σ_r L[s, r, e] u[r, e]
                z = torch.sum(Ls[name] * u[name][None, :, :], dim=1)
                contrib = torch.sum(Jd[ps] * z[:, None, :], dim=0)
                out[pt] += onehot_scatter_add_t(
                    data.plans[name]["ids32"][ps], contrib, p.counts[pt])
                m = window(data, name)[1]
                part = slab_sums(data, name, torch.sum(
                    Jd[ls][:, :, :m] * z[:, None, :m], dim=0)).T  # (S, dl)
                if spec.seg_identity:
                    out[lt][:part.shape[0]] += part
                else:
                    out[lt].index_add_(0, data.plans[name]["segp"], part)
            edge_sum_(data, *out.values())
            return out

        def build_precond(data, lin, lam):
            minv = {}
            for t, vt in p.vertex_types.items():
                eye = torch.eye(vt.tangent_dim, dtype=dtype, device=dev)
                blocks = lin.diag[t] + lam * eye
                fx = data.fixed[t].to(dtype)[:, None, None]
                minv[t] = inv_small(blocks * (1.0 - fx) + eye * fx)
            return minv

        def apply_precond(minv, rb):
            return {t: torch.einsum("nij,nj->ni", minv[t], rb[t])
                    for t in p.vertex_types}

        def dot_edges(a, b):
            return sum(torch.sum(a[k] * b[k]) for k in a)

        tdot = p.tree_dot

        def solve(data, lin, lam, aux=()):
            Ls = whiten(lin)
            minv = build_precond(data, lin, lam)
            # s0 = Jᵀ sqrt(W)ᵀ (sqrt(W) e) with b's sign is exactly lin.b
            s = p.split_tangent(lin.b)
            x = {t: torch.zeros_like(v) for t, v in s.items()}
            z = apply_precond(minv, s)
            gamma = tdot(s, z)
            pvec = z
            # the whitened data residual, with the sign of b = −JᵀWe: −Lᵀe
            r = {}
            for name in p.edge_types:
                e = lin.errors[name]
                if name in specs:
                    r[name] = -torch.sum(Ls[name] * e[:, None, :], dim=0)
                else:
                    r[name] = -torch.einsum("esr,es->er", Ls[name], e)
            g = float(gamma)
            thresh = eta * g
            it = 0
            while it < max_iter and g > thresh:
                q = Jmat(data, lin, Ls, pvec)
                qq = dot_edges(q, q)
                edge_sum_(data, qq)
                denom = qq + lam * tdot(pvec, pvec)
                alpha = gamma / torch.clamp_min(denom, 1e-300)
                x = {t: x[t] + alpha * pvec[t] for t in x}
                r = {k: r[k] - alpha * q[k] for k in r}
                jt = Jt(data, lin, Ls, r)
                s = {t: jt[t] - lam * x[t] for t in jt}
                z = apply_precond(minv, s)
                gamma_new = tdot(s, z)
                beta = gamma_new / torch.clamp_min(gamma, 1e-300)
                pvec = {t: z[t] + beta * pvec[t] for t in z}
                gamma = gamma_new
                g = float(gamma)
                it += 1
            self.solves += 1
            self.cg_iterations += it
            return p.join_tangent(x)

        self._solve_fn = solve
        self._setup_for = problem
        return self

    def solve(self, data, lin, lam=0.0):
        return self._solve_fn(data, lin, lam, self.aux)
