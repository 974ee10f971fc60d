"""Marginal covariance recovery — port of ``g2o_tpu/core/marginals.py``,
the analogue of the reference ``SparseOptimizer::computeMarginals``
(``g2o/core/sparse_optimizer.cpp:594``) backed by
``MarginalCovarianceCholesky`` (``g2o/core/marginal_covariance_cholesky.h:43``).

Four routes:

* **dense**: factor the dense tangent-space Hessian once and solve all
  requested unit columns in one triangular solve pair — the covariance
  blocks are ``(H⁻¹)[slots_i, slots_j]``;
* **sparse** (uniform-block graphs with binary edges): the
  :class:`~g2o_tpu_torch.core.solvers.supernodal.SupernodalCholeskySolver`'s
  factor and its panel sweeps over one batch of unit-block right-hand
  sides, all requested vertices at once;
* **takahashi**: one numeric factorization of
  :class:`~g2o_tpu_torch.core.solvers.sparse_chol.SparseCholeskySolver`
  and one reverse level sweep of the block Takahashi recursion give ALL
  diagonal blocks (mixed types ride its padded blocks);
* **schur** (bundle adjustment): the explicit
  :class:`~g2o_tpu_torch.core.solvers.schur.SchurSolver`'s reduced camera
  system — pose blocks from ``S⁻¹``, landmark blocks as
  ``D_j⁻¹ + Y_jᵀ S⁻¹ Y_j``.

``method="auto"`` takes ``schur`` for a problem with a full-type
marginalization, ``dense`` for partial marginalization or n-ary
observation edges, ``sparse`` when the dense Hessian would exceed ~32M
entries, else ``dense``.  A factor that is not positive definite gives NaN
blocks, as the JAX package's Cholesky does.  Results are host numpy
arrays, ``{vid: (d, d)}``; fixed vertices get zero covariance.
"""

from __future__ import annotations

import numpy as np
import torch

from g2o_tpu_torch.ops.smallblocks import cholesky_or_nan


def _spans_for(problem, vertex_ids):
    """Per requested vertex: (vid, type, local idx, dim, fixed)."""
    fixed = {t: problem.data.fixed[t].cpu().numpy()
             for t in problem.vertex_types}
    spans = []
    for vid in vertex_ids:
        t, i = problem.vid_index[vid]
        d = problem.vertex_types[t].tangent_dim
        spans.append((vid, t, i, d, bool(fixed[t][i])))
    return spans


def _sparse_applicable(problem) -> bool:
    """Binary edges only; mixed vertex types are fine (the direct solver
    pads blocks to the max tangent dim)."""
    return all(et.num_slots <= 2 for et in problem.edge_types.values())


def _uniform_type(problem) -> bool:
    return len(problem.vertex_types) == 1


def _supernodal_columns(problem, solver, blocks_of, *, lam, estimates):
    """``X = (H + λI)⁻¹ R`` through ``solver``'s (a set-up
    :class:`~g2o_tpu_torch.core.solvers.supernodal.SupernodalCholeskySolver`)
    factor and one pair of panel sweeps, for the unit-block right-hand
    sides ``R`` given as ``blocks_of = [(permuted block index, block
    dim)]``: ``(n, d, m)`` in permuted block order."""
    from g2o_tpu_torch.core.solvers.supernodal import solve_supernodal

    p = problem
    (tname,) = p.vertex_types
    d = p.vertex_types[tname].tangent_dim
    n = p.counts[tname]
    lin = p.linearize_fn(p.data, estimates)
    factors = solver._factor_fn(p.data, lin, lam, solver.aux)
    m = sum(db for _, db in blocks_of)
    rhs = torch.zeros((n, d, m), dtype=p.dtype, device=p.device)
    c = 0
    for k, db in blocks_of:
        rhs[k, :db, c:c + db] = torch.eye(db, dtype=p.dtype,
                                          device=p.device)
        c += db
    return solve_supernodal(factors, rhs, solver.aux["levels"], d)


def _supernodal(problem):
    """The supernodal solver set up for ``problem`` and its inverse
    permutation (original block -> permuted) on the host."""
    from g2o_tpu_torch.core.solvers.supernodal import SupernodalCholeskySolver

    solver = SupernodalCholeskySolver().setup(problem)
    return solver, solver.aux["inv"].cpu().numpy()


def _sparse_cov_blocks(problem, locals_, *, lam, estimates):
    """(k, d, d) diagonal covariance blocks via the supernodal factor, one
    sweep pair over the unit blocks of all ``k`` requested vertices."""
    p = problem
    (tname,) = p.vertex_types
    d = p.vertex_types[tname].tangent_dim
    solver, inv = _supernodal(p)
    kcols = [int(inv[i]) for i in locals_]
    X = _supernodal_columns(p, solver, [(k, d) for k in kcols], lam=lam,
                            estimates=estimates)
    return np.stack([X[k, :, j * d:(j + 1) * d].cpu().numpy()
                     for j, k in enumerate(kcols)]) if kcols else \
        np.zeros((0, d, d))


def _takahashi_cov_blocks(problem, *, lam, estimates):
    """ALL diagonal covariance blocks ``(n, d_max, d_max)`` (original
    vertex order) via ONE numeric factorization + ONE reverse
    level-scheduled Takahashi sweep — the batched formulation of the
    reference's ``computeCovariance`` over
    ``MarginalCovarianceCholesky::computeEntry``
    (``marginal_covariance_cholesky.h:85-96``)."""
    from g2o_tpu_torch.core.solvers.sparse_chol import (
        SparseCholeskySolver, build_takahashi_schedule, selected_inverse,
        trim_levels)

    p = problem
    solver = SparseCholeskySolver().setup(p)
    levels = trim_levels(solver._sched, p.device,
                         pairs=build_takahashi_schedule(solver._sym))
    n = solver._n_blocks
    lin = p.linearize_fn(p.data, estimates)
    blocks = solver._factor_fn(p.data, lin, lam, solver.aux)
    Sigma = selected_inverse(blocks, levels, n)
    cov = Sigma[:n][solver.aux["inv"]].cpu().numpy()
    return cov, solver._type_base


def _schur_marginals(problem, spans, *, lam, estimates):
    """Diagonal covariance blocks via the reduced camera system — the
    BA-scale path the reference reaches through CHOLMOD ``solveBlocks``
    (``solvers/cholmod/linear_solver_cholmod.h:160-230``).

    With ``H = [[A, B], [Bᵀ, D]]`` (poses / marginalized landmarks) and
    the Schur complement ``S = A − B D⁻¹ Bᵀ``:

    * pose blocks: ``Cov_pp = (S⁻¹)[p, p]`` from unit columns;
    * landmark blocks: ``Cov_jj = D_j⁻¹ + Y_jᵀ S⁻¹ Y_j`` with
      ``Y_j = (B D⁻¹)[:, j]`` scattered from the per-observation blocks —
      one scatter and one solve for ALL requested landmarks.

    Memory is O(Tp² + k·Tp·dl): no T×T Hessian is formed."""
    from g2o_tpu_torch.core.solvers.schur import SchurSolver

    p = problem
    solver = SchurSolver().setup(p)
    lay = solver._layout
    aux = solver.aux
    marg = lay["marg"]
    Tp, dl = lay["Tp"], lay["dl"]
    dtype, dev = p.dtype, p.device

    pose_req, lm_req = [], []     # (span position, reduced coordinate)
    for m, (vid, t, i, d, fx) in enumerate(spans):
        if marg[t]:
            lm_req.append((m, lay["lm_base"][t] + i))
        else:
            pose_req.append((m, lay["pose_base"][t] + i * d, d))

    lin = p.linearize_fn(p.data, estimates)
    kl = len(lm_req)
    lm_idx = torch.as_tensor([j for _, j in lm_req], dtype=torch.int64,
                             device=dev)
    pose_cols = torch.as_tensor(
        np.concatenate([np.arange(o, o + d) for _, o, d in pose_req])
        if pose_req else np.zeros(0, np.int64), dtype=torch.int64,
        device=dev)
    kp = pose_cols.shape[0]

    Hschur, _, B, Dinv = solver._reduced_parts_fn(p.data, lin, lam, aux)
    L = cholesky_or_nan(Hschur)

    # pose covariances: S⁻¹ unit columns
    rhs = torch.zeros((Tp, kp), dtype=dtype, device=dev)
    rhs[pose_cols, torch.arange(kp, device=dev)] = 1.0
    pose_cov = torch.cholesky_solve(rhs, L)[pose_cols, :]      # (kp, kp)

    # landmark covariances: Y_j = scatter of B_e Dinv_j over the
    # observations of each requested landmark (slot kl: not requested)
    obs_lm = aux["obs_lm"]
    BD = B @ Dinv[obs_lm]                                      # (Eo, dp, dl)
    slot_of = torch.full((lay["NL"],), kl, dtype=torch.int64, device=dev)
    slot_of[lm_idx] = torch.arange(kl, dtype=torch.int64, device=dev)
    flat = slot_of[obs_lm][:, None] * Tp + aux["cam_idx2"]     # (Eo, dp)
    Y = torch.zeros(((kl + 1) * Tp, dl), dtype=dtype, device=dev)
    Y.index_add_(0, flat.reshape(-1), BD.reshape(-1, dl))
    Y = Y.reshape(kl + 1, Tp, dl)[:kl]                         # (kl, Tp, dl)
    U = torch.cholesky_solve(
        Y.permute(1, 0, 2).reshape(Tp, kl * dl), L
    ).reshape(Tp, kl, dl).permute(1, 0, 2)                     # (kl, Tp, dl)
    lm_cov = Dinv[lm_idx] + torch.einsum("ktd,kte->kde", Y, U)
    pose_cov, lm_cov = pose_cov.cpu().numpy(), lm_cov.cpu().numpy()

    out = {}
    col = 0
    for (m, o, d) in pose_req:
        vid, _, _, _, is_fixed = spans[m]
        out[vid] = (np.zeros((d, d)) if is_fixed
                    else pose_cov[col:col + d, col:col + d])
        col += d
    for r, (m, _) in enumerate(lm_req):
        vid, _, _, d, is_fixed = spans[m]
        out[vid] = np.zeros((d, d)) if is_fixed else lm_cov[r][:d, :d]
    return out


def _dense_inverse_block(problem, cols, *, lam, estimates):
    """(k, k) block of (H + λI)⁻¹ for the given flat column indices."""
    p = problem
    lin = p.linearize_fn(p.data, estimates)
    cols = torch.as_tensor(np.asarray(cols, dtype=np.int64), device=p.device)
    H = p.dense_hessian_fn(p.data, lin)
    H.diagonal().add_(lam)
    L = cholesky_or_nan(H)
    rhs = torch.zeros((H.shape[0], cols.shape[0]), dtype=H.dtype,
                      device=p.device)
    rhs[cols, torch.arange(cols.shape[0], device=p.device)] = 1.0
    return torch.cholesky_solve(rhs, L)[cols, :].cpu().numpy()


def compute_marginals(problem, vertex_ids, *, lam: float = 0.0,
                      estimates=None, method: str = "auto"):
    """Covariance blocks for the given vertex ids: ``{vid: (d, d)
    ndarray}``.  Fixed vertices get zero covariance (they are pinned),
    the reference convention that fixed vertices are excluded from the
    system."""
    p = problem
    estimates = estimates if estimates is not None else p.estimates
    spans = _spans_for(p, vertex_ids)

    if method == "auto":
        if any(np.asarray(m).any() for m in p.marginalized.values()):
            # the explicit Schur path handles the standard full-type
            # marginalization pattern; general patterns (partial
            # marginalization, n-ary observation edges) take the dense
            # path rather than SchurSolver's guard
            partial = any(np.asarray(m).any() and not np.asarray(m).all()
                          for m in p.marginalized.values())
            nary_obs = any(
                et.num_slots > 2 and any(
                    np.asarray(p.marginalized[vt.name]).any()
                    for vt in et.vertex_types)
                for et in p.edge_types.values())
            method = "dense" if (partial or nary_obs) else "schur"
        elif (_sparse_applicable(p)
              and p.total_dim * p.total_dim > 32_000_000):
            method = "sparse"
        else:
            method = "dense"
    if method == "sparse" and not _sparse_applicable(p):
        raise NotImplementedError(
            "sparse marginals require a single uniform vertex type and "
            "binary edges")

    if method == "schur":
        return _schur_marginals(p, spans, lam=lam, estimates=estimates)

    out = {}
    if method == "takahashi":
        if not _sparse_applicable(p):
            raise NotImplementedError(
                "takahashi marginals require binary edges")
        cov_all, tbase = _takahashi_cov_blocks(p, lam=lam,
                                               estimates=estimates)
        for (vid, t, i, d, is_fixed) in spans:
            out[vid] = (np.zeros((d, d)) if is_fixed
                        else cov_all[tbase[t] + i][:d, :d])
        return out

    if method == "sparse":
        # requesting most of the graph — or a mixed-type graph (the
        # per-column supernodal path is uniform-type only): the Takahashi
        # sweep computes ALL blocks for one factorization's worth of work
        if (not _uniform_type(p)
                or len(spans) * 8 >= sum(p.counts.values())):
            return compute_marginals(p, vertex_ids, lam=lam,
                                     estimates=estimates,
                                     method="takahashi")
        locals_ = [i for (_, _, i, _, _) in spans]
        cov = _sparse_cov_blocks(p, locals_, lam=lam, estimates=estimates)
        for m, (vid, _, _, d, is_fixed) in enumerate(spans):
            out[vid] = np.zeros((d, d)) if is_fixed else cov[m]
        return out

    offsets = {t: p.data.offsets[t].cpu().numpy() for t in p.vertex_types}
    cols, pos = [], 0
    starts = []
    for (_, t, i, d, _) in spans:
        starts.append(pos)
        cols.extend(range(int(offsets[t][i]), int(offsets[t][i]) + d))
        pos += d
    block = _dense_inverse_block(p, cols, lam=lam, estimates=estimates)
    for (vid, _, _, d, is_fixed), start in zip(spans, starts):
        out[vid] = (np.zeros((d, d)) if is_fixed
                    else block[start:start + d, start:start + d])
    return out


def compute_cross_marginals(problem, vid_a, vid_b, *, lam: float = 0.0,
                            method: str = "dense"):
    """Cross-covariance block ``(H⁻¹)[a, b]`` (the condensed-edge
    construction of hierarchical optimization needs it)."""
    p = problem
    ta, ia = p.vid_index[vid_a]
    tb, ib = p.vid_index[vid_b]
    da = p.vertex_types[ta].tangent_dim
    db = p.vertex_types[tb].tangent_dim

    if method == "sparse":
        # the column right-hand side below unpacks the single vertex type
        if not _sparse_applicable(p) or not _uniform_type(p):
            raise NotImplementedError("sparse cross-marginals need a "
                                      "uniform-block problem with binary "
                                      "edges")
        solver, inv = _supernodal(p)
        ka, kb = int(inv[ia]), int(inv[ib])
        X = _supernodal_columns(p, solver, [(kb, db)], lam=lam,
                                estimates=p.estimates)
        return X[ka].cpu().numpy()

    offsets = {t: p.data.offsets[t].cpu().numpy() for t in p.vertex_types}
    oa, ob = int(offsets[ta][ia]), int(offsets[tb][ib])
    cols = list(range(oa, oa + da)) + list(range(ob, ob + db))
    M = _dense_inverse_block(p, cols, lam=lam, estimates=p.estimates)
    return M[:da, da:da + db]
