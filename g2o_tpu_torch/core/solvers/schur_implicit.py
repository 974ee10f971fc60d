"""Implicit (matrix-free) Schur-complement solver for large bundle
adjustment — port of ``g2o_tpu/core/solvers/schur_implicit.py``.

The explicit :class:`~g2o_tpu_torch.core.solvers.schur.SchurSolver`
enumerates every observation pair of a landmark (Σ deg² products) to form
the reduced camera matrix — far too many at the Venice scale.  Here the
reduced system

    S x = (Hpp − Hpl Dinv Hplᵀ) x = bschur

is solved by preconditioned CG with S·v applied from the per-observation
blocks:

    u_e = v[cam_e];  t_j = Σ_{e∈obs(j)} B_eᵀ u_e;  s_j = Dinv_j t_j;
    S v = Hpp v − Σ_e B_e s_{lm_e}

and the landmarks back-substitute as in the explicit path (the reference's
Schur loop, ``block_solver.hpp:339-393``).  The standard binary pattern
(one pose slot per observation edge, every vertex of a landmark type
marginalized) has three observation layouts:

* ``layout="rows"`` — row gathers and ``index_add_`` through each edge
  batch's ``vidx``;
* ``layout="bucketed"`` on a problem built WITHOUT ``bucket_landmarks`` —
  at setup the observations are planned into the landmark-degree buckets
  of ``g2o_tpu_torch/ops/bucketed.py`` (a host plan): the B blocks of the
  real rows are taken in slab order, the landmark side reduces per slab
  with the padding slots left zero, the camera side gathers and sums with
  the row-major kernels of ``ops/onehot.py``;
* a problem built WITH ``bucket_landmarks=True`` (``layout="auto"`` picks
  it): fully DIMS-MAJOR (``dm``) — the off-diagonal blocks and the
  bucket-order landmark system come from the linearization's ``extras``,
  the camera side runs the dims-major gather and segment-sum kernels, and
  no landmark-axis index op is left in the CG body.  On unsharded data
  the Schur term of each ``S·v`` is one call of the Schur rows kernel
  (``ops/onehot.py::schur_rows_t``: the gather, ``Bᵀu``, the slab sums,
  ``Dinv``, ``B s`` and the camera sums in one pass over B).

A landmark type observed by several edge types (ORB-SLAM's mono and stereo
edges on one map) keeps the bucketed slabs per edge type but leaves the
dims-major path (each batch's extras hold one edge type's share of the
landmark system): per-slab sums are added into natural landmark order
(``seg_add``), inverted there and read back per batch (``seg_take``); the
camera side stays on the row-major gather and segment-sum kernels.

Every other pattern takes the general path (rows layout only): n-ary
observation edges, one B block per (edge type, pose slot) — inverse-depth
``EDGE_PROJECT_PSI2UV`` couples a point to its observing and its anchor
camera — and per-vertex partial marginalization, whose retained landmark
rows ride the CG beside the poses.

Preconditioners: ``"schur_jacobi"`` (default) — the per-camera diagonal
blocks of the REDUCED system, ``Hpp_jj − Σ B_e Dinv B_eᵀ``; ``"jacobi"`` —
the damped ``Hpp`` blocks.  Neither holds the cross term of a vertex that
sits in two slots of one edge (an observer that is its own anchor); the
matvec does.  ``deflate_basis`` (``{pose type: (N, d, k)}``, orthonormal,
e.g. :func:`g2o_tpu_torch.types.bal.bal_gauge_basis`) runs CG on the
orthogonal complement of the free-gauge null space (binary path only).

Sharded data (``ProblemData.group``: each process holds a slice of the edge
rows) runs in every layout: every sum over edges into a per-vertex result
— ``bschur``, the preconditioner's blocks, the landmark and camera sums of
each ``S·v`` and the back-substitution's landmark sums — is this
process's partial sum, completed by one all-reduce (a replicated term
counted on the first process only); the CG vectors and its stop test stay
replicated.  A bucketed batch works on the slab rows this process holds,
in slab order: a contiguous window of a compile-time bucketed batch, or,
on a plan made at setup, the rows of its window mapped through the plan
(``rows_here``); its per-row landmark terms sit at their slab places in a
zeroed full-width buffer for the per-slab sums.

The JAX package's ``lax.while_loop`` is a Python loop here: its stop test
reads one scalar from the device per CG iteration.  ``matvec_precision`` is
accepted for API parity: TF32 stays off, so every product is full
float32/float64.
"""

from __future__ import annotations

import numpy as np
import torch

from g2o_tpu_torch.core.problem import (edge_chunks, edge_sum_, full_rows,
                                        replicated_part, row_window)
from g2o_tpu_torch.ops.bucketed import (bucket_by_segment,
                                        slab_broadcast_t, slab_sum_t)
from g2o_tpu_torch.ops.onehot import (onehot_gather, onehot_gather_t,
                                      onehot_scatter_add,
                                      onehot_scatter_add_t, schur_rows_fits,
                                      schur_rows_order, schur_rows_t,
                                      schur_rows_tiled_fits,
                                      schur_rows_tiled_t)
from g2o_tpu_torch.ops.smallblocks import inv_small, inv_small_t
from g2o_tpu_torch.utils.tictoc import span


def _damped_diag(p, data, lin, lam, types):
    """``H_jj + λI`` per vertex of ``types``; a unit block on fixed ones."""
    out = {}
    for t in types:
        eye = torch.eye(p.vertex_types[t].tangent_dim, dtype=p.dtype,
                        device=p.device)
        fx = data.fixed[t].to(p.dtype)[:, None, None]
        out[t] = (lin.diag[t] + lam * eye) * (1.0 - fx) + eye * fx
    return out


def _apply_blocks(blocks, v, types):
    """``{t: blocks[t] · v[t]}``, a batched block matvec per type."""
    return {t: torch.einsum("nij,nj->ni", blocks[t], v[t]) for t in types}


def _pair_couplings(out, et, vidx, Js, W, slots, vb):
    """Add the off-diagonal ``Hᵢⱼ v`` of every slot pair of ``slots`` (i ≠
    j) of one edge batch into ``out`` (row-major Jacobians)."""
    for i in slots:
        acc = None
        for j in slots:
            if i == j:
                continue
            h = torch.einsum("erd,ers,esf,ef->ed", Js[i], W, Js[j],
                             vb[et.vertex_types[j].name][vidx[:, j]])
            acc = h if acc is None else acc + h
        if acc is not None:
            ti = et.vertex_types[i].name
            out[ti] = out[ti].index_add(0, vidx[:, i], acc)
    return out


def _pcg(S_vec, precond, project, bschur, types, tol, max_iter, carry):
    """PCG on the reduced system; ``(x, stats)``.  The stop test ``‖r‖² ≤
    max(tol²‖b‖², carry)`` is read on the host once per iteration;
    ``carry`` (half the previous solve's final ‖r‖²) is the reference PCG's
    absoluteTolerance continuation (``linear_solver_pcg.hpp:124-127,149``)."""
    def pdot(a, b):
        return sum(torch.sum(a[t] * b[t]) for t in types)

    x = {t: torch.zeros_like(bschur[t]) for t in types}
    r = project(bschur)
    z = project(precond(r))
    pv, rz = z, pdot(r, z)
    rhs2 = pdot(bschur, bschur)
    thresh = tol * tol * rhs2
    if carry is not None:
        thresh = torch.maximum(thresh, carry.to(thresh.dtype))

    def go_on(it):
        if it >= max_iter:
            return False
        with span("read.cg_stop"):
            return bool(pdot(r, r) > thresh)

    it = 0
    running = go_on(it)
    while running:
        # an iteration's span closes after the stop test that follows it
        with span("cg.iter"):
            Ap = project(S_vec(pv))
            alpha = rz / pdot(pv, Ap)
            x = {t: x[t] + alpha * pv[t] for t in types}
            r = {t: r[t] - alpha * Ap[t] for t in types}
            z = project(precond(r))
            rz2 = pdot(r, z)
            pv = {t: z[t] + (rz2 / rz) * pv[t] for t in types}
            rz = rz2
            it += 1
            running = go_on(it)
    res2 = pdot(r, r)
    return x, {"cg_iterations": it, "residual2": res2, "rhs2": rhs2,
               "carry": 0.5 * res2}


def _unprojected(vb):
    return vb


class ImplicitSchurSolver:
    name = "schur_implicit"

    def __init__(self, max_iter: int = 100, tol: float = 1e-8, *,
                 precond: str = "schur_jacobi", layout: str = "auto",
                 onehot_max_segments: int = 8192, max_buckets: int = 10,
                 matvec_precision: str = "auto",
                 absolute_tolerance: bool = True,
                 deflate_basis=None):
        if layout not in ("auto", "rows", "bucketed"):
            raise ValueError(f"unknown layout {layout!r}")
        if precond not in ("schur_jacobi", "jacobi"):
            raise ValueError(f"unknown precond {precond!r}")
        if matvec_precision not in ("auto", "default", "highest"):
            raise ValueError(f"unknown matvec_precision {matvec_precision!r}")
        self.max_iter = int(max_iter)
        self.tol = float(tol)
        self.precond = precond
        self.layout = layout
        # the JAX package's TPU gather routing: accepted and ignored (the
        # kernels take any segment count)
        self.onehot_max_segments = int(onehot_max_segments)
        self.max_buckets = int(max_buckets)
        self.matvec_precision = matvec_precision
        # reference-PCG absoluteTolerance: half the final residual² of one
        # solve floors the next solve's stop threshold
        # (solvers/pcg/linear_solver_pcg.hpp:124-127,149)
        self.absolute_tolerance = bool(absolute_tolerance)
        self.deflate_basis = deflate_basis
        self.aux = ()
        self.state0 = None
        self._host_state = None
        self._setup_for = None

    # ------------------------------------------------------------------ #

    def _classify(self, problem):
        """``(lm_types, pose_types, obs_specs, pose_edge_types, partial,
        general)``; ``obs_specs`` entries are ``(name, pose_slots,
        lm_slot)``.  An edge type observes a landmark iff one endpoint in a
        marginal slot is marginalized (``block_solver.hpp:224-253``); edges
        coupling two marginalized vertices are rejected."""
        p = problem
        marg_np = {t: np.asarray(m) for t, m in p.marginalized.items()}
        lm_types = [t for t, m in marg_np.items() if m.any()]
        pose_types = [t for t in p.vertex_types if t not in lm_types]
        partial = {t: bool(marg_np[t].any() and not marg_np[t].all())
                   for t in p.vertex_types}
        if not lm_types:
            raise ValueError("ImplicitSchurSolver: no marginalized vertices")
        obs_specs, pose_edge_types = [], []
        for name, et in p.edge_types.items():
            lm_slots = [s for s, vt in enumerate(et.vertex_types)
                        if vt.name in lm_types]
            if not lm_slots:
                pose_edge_types.append(name)
                continue
            vidx = full_rows(p.data, p.data.edges[name].vidx).cpu().numpy()
            hot = [s for s in lm_slots
                   if marg_np[et.vertex_types[s].name][
                       np.minimum(vidx[:, s],
                                  len(marg_np[et.vertex_types[s].name]) - 1)
                   ].any()]
            if len(hot) > 1:
                raise NotImplementedError(
                    f"{name}: edges coupling two marginalized vertices are "
                    "not supported (Hll must stay block-diagonal)")
            if not hot:
                pose_edge_types.append(name)
                continue
            ls = hot[0]
            obs_specs.append(
                (name, tuple(s for s in range(et.num_slots) if s != ls), ls))
        general = (any(partial[t] for t in lm_types)
                   or any(len(ps) != 1 for _, ps, _ in obs_specs))
        return (lm_types, pose_types, obs_specs, pose_edge_types, partial,
                general)

    def setup(self, problem, force: bool = False):
        """Classify the graph, plan the layout and build the solve
        closures (a no-op when called again for the same problem)."""
        if self._setup_for is problem and not force:
            return self
        p = problem
        (lm_types, pose_types, obs_specs, pose_edge_types, partial,
         general) = self._classify(p)
        if general:
            # n-ary observation edges or per-vertex partial
            # marginalization: the exact rows-layout general path
            if self.layout == "bucketed":
                raise NotImplementedError(
                    "layout='bucketed' supports the standard binary "
                    "pose-landmark pattern only; this graph needs the "
                    "general path (layout='rows'/'auto')")
            return self._setup_general(p, lm_types, pose_types, obs_specs,
                                       pose_edge_types, partial)
        obs_specs = [(name, ps[0], ls) for name, ps, ls in obs_specs]
        dtype, dev = p.dtype, p.device
        use_schur_precond = self.precond == "schur_jacobi"
        pre = {name: name in p.bucket_specs for name, _, _ in obs_specs}
        if self.layout == "bucketed":
            bucketed = True
        elif self.layout == "auto":
            bucketed = bool(obs_specs) and all(pre.values())
        else:
            bucketed = False
        lm_of = {name: p.edge_types[name].vertex_types[ls].name
                 for name, _, ls in obs_specs}
        pt_of = {name: p.edge_types[name].vertex_types[ps].name
                 for name, ps, _ in obs_specs}
        # a landmark type observed by ONE edge type runs the CG body in
        # bucket order (BAL and every standard BA graph); a batch of a
        # compile-time bucketed problem whose landmark type has one
        # observer is fully dims-major (``dm``)
        users = {}
        for name, _, _ in obs_specs:
            users.setdefault(lm_of[name], []).append(name)
        sole_obs = {name: len(users[lm_of[name]]) == 1
                    for name, _, _ in obs_specs}
        dm = {name: bucketed and pre[name] and sole_obs[name]
              for name, _, _ in obs_specs}
        dm_lm = {lm_of[name] for name, _, _ in obs_specs if dm[name]}
        # the route of a ``dm`` batch's Schur term of S·v (unsharded data):
        # one call of the Schur rows kernel, whose blocks hold the camera
        # sums in shared memory where they fit (``shared``), else of its
        # tiled form (``tiled``); a batch without one composes it
        route = {}
        for name, _, _ in obs_specs:
            fits = (p.counts[pt_of[name]],
                    p.vertex_types[pt_of[name]].tangent_dim,
                    p.vertex_types[lm_of[name]].tangent_dim, dtype)
            if dm[name] and schur_rows_fits(*fits):
                route[name] = "shared"
            elif dm[name] and schur_rows_tiled_fits(*fits):
                route[name] = "tiled"
        # the obs batches whose Schur term reduces in natural landmark order
        rem = [spec for spec in obs_specs
               if not (bucketed and sole_obs[spec[0]])]
        rem_lm = list(dict.fromkeys(lm_of[name] for name, _, _ in rem))

        # ---------------- host symbolic phase: bucket plans ------------- #
        # a batch bucketed at run time keeps its plan's slab order on the
        # host (``perm_src``: the batch row of each slab row, the batch's
        # row count on a padding row) with the camera id of every batch row
        bspec, aux, plans = {}, {}, {}
        if bucketed:
            for name, ps, ls in obs_specs:
                if pre[name]:
                    sp = p.bucket_specs[name]
                    bspec[name] = (sp.counts, sp.degrees, sp.n_rows)
                    continue
                # every edge row (gathered when this process holds a slice)
                vidx = full_rows(p.data,
                                 p.data.edges[name].vidx).cpu().numpy()
                plan = bucket_by_segment(vidx[:, ls], p.counts[lm_of[name]],
                                         max_buckets=self.max_buckets)
                plans[name] = (plan.perm_src.astype(np.int64),
                               vidx[:, ps].astype(np.int64))
                aux[name] = dict(
                    segp=torch.as_tensor(plan.seg_perm.astype(np.int64),
                                         device=dev))
                bspec[name] = (plan.counts, plan.degrees,
                               int(len(plan.perm_src)))
        if self.deflate_basis:
            aux["deflate_G"] = {
                t: torch.as_tensor(np.asarray(v), dtype=dtype, device=dev)
                for t, v in self.deflate_basis.items()}
        self.aux = aux

        held = {}

        def rows_here(data, name):
            """``(sel, places, cam)``: the slab rows of batch ``name`` that
            this process holds, in slab order — ``sel`` picks them from its
            own rows, ``places`` gives their slab positions and ``cam``
            their camera ids (int32, for the kernels).  A compile-time
            bucketed batch is in slab order already (slices over its
            window); a run-time plan maps the process's row window through
            ``perm_src`` (its padding rows lie in no window: their B is
            zero).  Unsharded data is the window of every row."""
            lo, n = row_window(data, name)
            nb = bspec[name][2]
            if pre[name]:
                m = max(0, min(n, nb - lo))
                ps = p.bucket_specs[name].pose_slot
                return (slice(0, m), slice(lo, lo + m),
                        data.plans[name]["ids32"][ps, :m])
            key = (name, lo, n)
            if key not in held:
                perm_src, cam = plans[name]
                q = np.nonzero((perm_src >= lo) & (perm_src < lo + n))[0]
                src = perm_src[q]
                held[key] = (
                    torch.as_tensor(src - lo, device=dev),
                    torch.as_tensor(q, device=dev),
                    torch.as_tensor(cam[src].astype(np.int32), device=dev))
            return held[key]

        orders = {}

        def cam_order(name, ids, n_cam):
            """The tiled Schur rows form's camera order of the rows
            ``ids`` of unsharded batch ``name``, made at its first use."""
            if name not in orders:
                orders[name] = schur_rows_order(ids, n_cam)
            return orders[name]

        def take(x, idx):
            """``x[..., idx]`` for a slice or an index tensor."""
            if isinstance(idx, slice):
                return x[..., idx]
            return x.index_select(x.dim() - 1, idx)

        def slab_sums(data, name, z):
            """Per-row ``(k, n_here)`` -> per-segment ``(k, S_used)`` sums
            in bucket order: the rows sit at their places in a zeroed
            full-width slab buffer, each degree-major slab a ``(k, deg,
            n)`` view summed over deg.  Sharded, these are this process's
            partial sums."""
            counts, degrees, nb = bspec[name]
            places = rows_here(data, name)[1]
            if not (isinstance(places, slice) and places == slice(0, nb)):
                zf = z.new_zeros(z.shape[:-1] + (nb,))
                if isinstance(places, slice):
                    zf[..., places] = z
                else:
                    zf.index_copy_(zf.dim() - 1, places, z)
                z = zf
            return slab_sum_t(counts, degrees, z)

        def bucket_down_t(Bt, ut, data, name):
            """Σ_rows Bᵀu, dims-major: Bt (dp, dl, n_here), ut (dp,
            n_here) -> (dl, S_used) in bucket order, completed over the
            processes by one all-reduce."""
            out = slab_sums(data, name, torch.sum(Bt * ut[:, None, :], dim=0))
            edge_sum_(data, out)
            return out

        def rows_of(data, name, x):
            """Per-segment ``(..., S_used)`` -> the rows held here
            ``(..., n_here)``."""
            counts, degrees, _ = bspec[name]
            return take(slab_broadcast_t(counts, degrees, x),
                        rows_here(data, name)[1])

        def bucket_up_t(Bt, x):
            """B s per row, dims-major: x (dl, n_here) -> (dp, n_here)."""
            return torch.sum(Bt * x[None], dim=1)

        def seg_ident(name):
            return pre[name] and p.bucket_specs[name].seg_identity

        def segp_of(data, name):
            return (data.plans[name]["segp"] if pre[name]
                    else aux[name]["segp"])

        # bucket-order <-> natural-order landmark rows: slices when the type
        # was reordered into bucket order at compile time, else ``segp``
        def seg_take(data, name, arr):
            if seg_ident(name):
                return arr[:sum(p.bucket_specs[name].counts)]
            return arr[segp_of(data, name)]

        def seg_add(data, name, out, vals):
            if seg_ident(name):
                return torch.cat([out[:vals.shape[0]] + vals,
                                  out[vals.shape[0]:]])
            return out.index_add(0, segp_of(data, name), vals)

        def seg_set(data, name, out, vals):
            out = out.clone()
            if seg_ident(name):
                out[:vals.shape[0]] = vals
            else:
                out[segp_of(data, name)] = vals
            return out

        def gather_t(data, name, v):
            """``v[cam]`` of the rows held here, dims-major ``(d,
            n_here)``: the dims-major gather on a ``dm`` batch, the
            row-major one elsewhere."""
            ids = rows_here(data, name)[2]
            if dm[name]:
                return onehot_gather_t(ids, v)
            return onehot_gather(ids, v).T

        def cam_sum_t(data, name, rows_t, n_cam, sl=slice(None)):
            """Σ per camera of dims-major rows ``(D, n)`` (the rows ``sl``
            of those held here) -> ``(n_cam, D)``: this process's partial
            sums, with the dims-major segment sum on a ``dm`` batch and the
            row-major one elsewhere."""
            ids = rows_here(data, name)[2][sl]
            if dm[name]:
                return onehot_scatter_add_t(ids, rows_t, n_cam)
            return onehot_scatter_add(ids, rows_t.T.contiguous(), n_cam)

        # ------------------------------------------------------------------ #
        # per-λ-trial stages
        # ------------------------------------------------------------------ #

        def landmark_system(data, lin, lam, aux):
            """Landmark inverses and off-diagonal blocks: a dict ``ctx``
            the later stages read.  The ``dm`` batches take B and their
            bucket-order landmark system from the linearization's extras;
            the others build B = Jpᵀ W Jl dims-major from the Jacobians.
            ``Bt`` and ``DinvT`` of a bucketed batch hold its rows held
            here in slab order and its landmark inverses in bucket
            order."""
            ext = lin.extras or {}
            Dinv = {t: inv_small(D) for t, D in _damped_diag(
                p, data, lin, lam,
                [t for t in lm_types if t not in dm_lm]).items()}
            Bt_b, DinvT, bl_bt = {}, {}, {}
            for name, ps, ls in obs_specs:
                if not dm[name]:
                    continue
                d = p.vertex_types[lm_of[name]].tangent_dim
                Bt_b[name] = take(ext[name]["Bt"], rows_here(data, name)[0])
                bl_bt[name] = ext[name]["bl_bucket_t"]            # (d, S)
                Hll_t = ext[name]["Hll_bucket_t"].reshape(d, d, -1)
                eye_t = torch.eye(d, dtype=dtype, device=dev)[:, :, None]
                # all-zero blocks are fixed landmarks (their Jacobian slots
                # are masked at linearize): a unit block, dx = 0
                zero = (Hll_t == 0).all(dim=0).all(dim=0)[None, None, :]
                DinvT[name] = inv_small_t(
                    torch.where(zero, eye_t, Hll_t + lam * eye_t))
            B = {}
            for name, ps, ls in obs_specs:
                if dm[name]:
                    continue
                Js, W = lin.jacs[name], lin.weights[name]
                if pre[name]:                    # dims-major leaves already
                    Jpt, Jlt, Wt = Js[ps], Js[ls], W
                else:
                    Jpt = Js[ps].permute(1, 2, 0)            # (r, dp, E)
                    Jlt = Js[ls].permute(1, 2, 0)            # (r, dl, E)
                    Wt = W.permute(1, 2, 0)                  # (r, s, E)
                WJl = torch.sum(Wt[:, :, None, :] * Jlt[None], dim=1)
                Bt = torch.sum(Jpt[:, :, None, :] * WJl[:, None],
                               dim=0)                        # (dp, dl, E)
                if bucketed:
                    Bt_b[name] = take(Bt, rows_here(data, name)[0])
                    DinvT[name] = seg_take(data, name,
                                           Dinv[lm_of[name]]).permute(1, 2, 0)
                else:
                    B[name] = Bt.permute(2, 0, 1)
            ctx = dict(Dinv=Dinv, Bt=Bt_b, DinvT=DinvT, bl_bt=bl_bt, B=B)
            ball = p.split_tangent(lin.b)
            ctx["bl"] = {t: ball[t] for t in lm_types}
            ctx["bp"] = {t: ball[t] for t in pose_types}
            return ctx

        def reduced_rhs(ctx, data, lin, aux):
            """``bschur = bp − B · (Dinv bl)``."""
            Dinv, bl = ctx["Dinv"], ctx["bl"]
            y = _apply_blocks(Dinv, bl, [t for t in lm_types
                                         if t not in dm_lm])
            bschur = {t: replicated_part(data, v)
                      for t, v in ctx["bp"].items()}
            for name, ps, ls in obs_specs:
                pt, lt = pt_of[name], lm_of[name]
                if bucketed:
                    if dm[name]:
                        y_bt = torch.einsum("ijn,jn->in", ctx["DinvT"][name],
                                            ctx["bl_bt"][name])
                    else:
                        y_bt = seg_take(data, name, y[lt]).T
                    rows_t = bucket_up_t(ctx["Bt"][name],
                                         rows_of(data, name, y_bt))
                    bschur[pt] = bschur[pt] - cam_sum_t(data, name, rows_t,
                                                        p.counts[pt])
                else:
                    vidx = data.edges[name].vidx
                    bschur[pt] = bschur[pt].index_add(
                        0, vidx[:, ps], torch.einsum(
                            "edl,el->ed", ctx["B"][name], y[lt][vidx[:, ls]]),
                        alpha=-1)
            edge_sum_(data, *bschur.values())
            return bschur

        def preconditioner(ctx, data, lin, lam, aux):
            """``(diag_blocks, minv)``: the damped Hpp blocks and the
            inverses of the preconditioner blocks (``schur_jacobi``: the
            reduced system's camera blocks).  Fixed cameras keep their unit
            blocks: their B rows are zero."""
            diag_blocks = _damped_diag(p, data, lin, lam, pose_types)
            sdiag = dict(diag_blocks)
            if use_schur_precond:
                sdiag = {t: replicated_part(data, v)
                         for t, v in diag_blocks.items()}
                for name, ps, ls in obs_specs:
                    pt, lt = pt_of[name], lm_of[name]
                    if bucketed:
                        # C = B Dinv Bᵀ per row, dims-major, over edge
                        # chunks in order: no (dp, dp, dl, n) product of
                        # the whole edge axis
                        Bts = ctx["Bt"][name]
                        dp_, dl_, n_ = Bts.shape
                        Drows = rows_of(data, name, ctx["DinvT"][name])
                        for sl in edge_chunks(n_, dp_ * dp_ * dl_):
                            with span("edge_chunk"):
                                B_c = Bts[..., sl]
                                T_ = torch.sum(B_c[:, :, None, :]
                                               * Drows[..., sl][None], dim=1)
                                C_t = torch.sum(T_[:, None, :, :] * B_c[None],
                                                dim=2)
                                del T_
                                sdiag[pt] = sdiag[pt] - cam_sum_t(
                                    data, name, C_t.reshape(dp_ * dp_, -1),
                                    p.counts[pt], sl).reshape(-1, dp_, dp_)
                                del C_t
                    else:
                        vidx = data.edges[name].vidx
                        Bn = ctx["B"][name]
                        C = torch.einsum("edl,elm,efm->edf", Bn,
                                         ctx["Dinv"][lt][vidx[:, ls]], Bn)
                        sdiag[pt] = sdiag[pt].index_add(0, vidx[:, ps], C,
                                                        alpha=-1)
                edge_sum_(data, *sdiag.values())
            return diag_blocks, {t: inv_small(sdiag[t]) for t in pose_types}

        def S_vec(ctx, data, lin, diag_blocks, vb):
            """The reduced-system product ``S·v`` in block layout (completed
            over the processes of sharded data)."""
            out = S_vec_part(ctx, data, lin, diag_blocks, vb)
            edge_sum_(data, *out.values())
            return out

        def S_vec_part(ctx, data, lin, diag_blocks, vb):
            """This process's share of ``S·v``: the replicated diagonal term
            on the first process only, the edge terms of its rows."""
            out = {t: replicated_part(data, v) for t, v in _apply_blocks(
                diag_blocks, vb, pose_types).items()}
            # pose-pose edges: the off-diagonal Hpp couplings
            for name in pose_edge_types:
                Js = p.edge_jacs(lin, name)
                out = _pair_couplings(out, p.edge_types[name],
                                      data.edges[name].vidx, Js,
                                      p.edge_weights(lin, name),
                                      range(len(Js)), vb)
            # the Schur term − B Dinv Bᵀ v; a landmark type with one
            # observer edge type stays in bucket order.  Sharded, a
            # landmark's rows may lie on several processes: its sum Bᵀv
            # is completed by an all-reduce before Dinv
            if bucketed:
                for name, ps, ls in obs_specs:
                    if not sole_obs[name]:
                        continue
                    pt = pt_of[name]
                    Bts = ctx["Bt"][name]
                    kind = route.get(name) if data.group is None else None
                    if kind:
                        counts, degrees, _ = bspec[name]
                        ids = rows_here(data, name)[2]
                        args = (counts, degrees, Bts, ids, ctx["DinvT"][name],
                                vb[pt])
                        out[pt] = out[pt] - (
                            schur_rows_t(*args) if kind == "shared" else
                            schur_rows_tiled_t(
                                *args, cam_order(name, ids, p.counts[pt])))
                        continue
                    t_ = bucket_down_t(Bts, gather_t(data, name, vb[pt]),
                                       data, name)
                    s_t = torch.sum(ctx["DinvT"][name] * t_[None], dim=1)
                    rows_t = bucket_up_t(Bts, rows_of(data, name, s_t))
                    out[pt] = out[pt] - cam_sum_t(data, name, rows_t,
                                                  p.counts[pt])
            if not rem:
                return out
            # the other batches: Bᵀv summed per landmark in natural order,
            # Dinv there, B s read back per row
            tl = {t: torch.zeros((p.counts[t], p.vertex_types[t].tangent_dim),
                                 dtype=dtype, device=dev) for t in rem_lm}
            for name, ps, ls in rem:
                pt, lt = pt_of[name], lm_of[name]
                if bucketed:
                    z = torch.sum(ctx["Bt"][name]
                                  * gather_t(data, name, vb[pt])[:, None],
                                  dim=0)
                    tl[lt] = seg_add(data, name, tl[lt],
                                     slab_sums(data, name, z).T)
                else:
                    vidx = data.edges[name].vidx
                    tl[lt].index_add_(0, vidx[:, ls], torch.einsum(
                        "edl,ed->el", ctx["B"][name], vb[pt][vidx[:, ps]]))
            edge_sum_(data, *tl.values())
            s_ = _apply_blocks(ctx["Dinv"], tl, rem_lm)
            for name, ps, ls in rem:
                pt, lt = pt_of[name], lm_of[name]
                if bucketed:
                    rows_t = bucket_up_t(ctx["Bt"][name], rows_of(
                        data, name, seg_take(data, name, s_[lt]).T))
                    out[pt] = out[pt] - cam_sum_t(data, name, rows_t,
                                                  p.counts[pt])
                else:
                    vidx = data.edges[name].vidx
                    out[pt] = out[pt].index_add(0, vidx[:, ps], torch.einsum(
                        "edl,el->ed", ctx["B"][name], s_[lt][vidx[:, ls]]),
                        alpha=-1)
            return out

        def cg(ctx, data, lin, bschur, diag_blocks, minv, aux, carry=None):
            """PCG on the reduced system; ``(dxp, stats)``."""
            G = aux.get("deflate_G") if isinstance(aux, dict) else None

            def project(vb):
                coef = sum(torch.einsum("ndk,nd->k", Gt, vb[t])
                           for t, Gt in G.items())
                out = dict(vb)
                for t, Gt in G.items():
                    out[t] = vb[t] - torch.einsum("ndk,k->nd", Gt, coef)
                return out

            return _pcg(lambda v: S_vec(ctx, data, lin, diag_blocks, v),
                        lambda rb: _apply_blocks(minv, rb, pose_types),
                        _unprojected if G is None else project, bschur,
                        pose_types, self.tol, self.max_iter, carry)

        def back_substitute(ctx, data, lin, dxp, aux):
            """``dxl = Dinv (bl − Bᵀ dxp)`` joined with ``dxp`` into the
            full update; a ``dm`` batch stays in bucket order until one
            placement into natural order."""
            bl = ctx["bl"]
            wl = {t: torch.zeros_like(bl[t])
                  for t in lm_types if t not in dm_lm}
            dxl = {}
            for name, ps, ls in obs_specs:
                pt, lt = pt_of[name], lm_of[name]
                if dm[name]:
                    t_ = bucket_down_t(ctx["Bt"][name],
                                       gather_t(data, name, dxp[pt]),
                                       data, name)
                    dxl_t = torch.einsum("ijn,jn->in", ctx["DinvT"][name],
                                         ctx["bl_bt"][name] - t_)
                    d = p.vertex_types[lt].tangent_dim
                    dxl[lt] = seg_set(data, name, torch.zeros(
                        (p.counts[lt], d), dtype=dtype, device=dev), dxl_t.T)
                elif bucketed:
                    z = torch.sum(ctx["Bt"][name]
                                  * gather_t(data, name, dxp[pt])[:, None],
                                  dim=0)
                    wl[lt] = seg_add(data, name, wl[lt],
                                     slab_sums(data, name, z).T)
                else:
                    vidx = data.edges[name].vidx
                    wl[lt] = wl[lt].index_add(0, vidx[:, ls], torch.einsum(
                        "edl,ed->el", ctx["B"][name], dxp[pt][vidx[:, ps]]))
            edge_sum_(data, *wl.values())
            for t in lm_types:
                if t not in dm_lm:
                    dxl[t] = torch.einsum("nij,nj->ni", ctx["Dinv"][t],
                                          bl[t] - wl[t])
            return p.join_tangent({**dxp, **dxl})

        if not bucketed:
            form = "rows"
        elif not all(sole_obs.values()):
            form = "multi_observer"
        elif all(dm.values()):
            form = "dm"
        else:
            form = "runtime_bucketed" if not any(pre.values()) else "bucketed"
        self._rows_here = rows_here
        return self._finish(p, dict(
            landmark_system=landmark_system, reduced_rhs=reduced_rhs,
            preconditioner=preconditioner, cg=cg,
            back_substitute=back_substitute), dict(
            bucketed=bucketed, form=form,
            buckets={name: len(s[0]) for name, s in bspec.items()},
            slab_rows={name: s[2] for name, s in bspec.items()},
            schur_rows=dict(route)))

    def _setup_general(self, p, lm_types, pose_types, obs_specs,
                       pose_edge_types, partial):
        """The exact rows-layout path for the GENERAL marginalization
        patterns the reference supports (``block_solver.hpp:224-253,
        315-447``, ``base_multi_edge.h:51,115``):

        * n-ary observation edges — several pose slots per edge, e.g.
          inverse-depth ``EdgeProjectPSI2UV`` (point psi, observer, anchor;
          ``types/sba/types_six_dof_expmap.h:183``): every pose-slot pair
          adds an Hpp coupling, and every pose slot couples to the
          marginalized slot through its own B block;
        * per-vertex partial marginalization — a strict subset of a type's
          vertices is eliminated (the per-edge ``elim`` mask); the retained
          vertices of that type ride the reduced CG system beside the pose
          types, pinned to zero on eliminated rows (the ``marg`` mask).
        """
        dtype, dev = p.dtype, p.device
        use_schur_precond = self.precond == "schur_jacobi"
        cg_types = pose_types + [t for t in lm_types if partial[t]]
        full_lm = [t for t in lm_types if not partial[t]]
        if self.deflate_basis:
            # the analytic gauge bases are built for the standard BAL
            # camera/landmark split; dropping the request silently would
            # leave late free-gauge solves grinding the cap
            raise NotImplementedError(
                "deflate_basis is not supported on the general "
                "(n-ary/partial) marginalization path")

        # the masks, in aux: per partial type its marginalized vertices,
        # per observation batch its rows whose landmark is eliminated
        marg_np = {t: np.asarray(p.marginalized[t]) for t in lm_types}
        aux = {"marg": {}, "elim": {}}
        for t in lm_types:
            if partial[t]:
                aux["marg"][t] = torch.as_tensor(
                    marg_np[t].astype(np.float64), dtype=dtype, device=dev)
        lt_of = {}
        for name, pslots, ls in obs_specs:
            lt = lt_of[name] = p.edge_types[name].vertex_types[ls].name
            # every edge row's mask (gathered when this process holds a
            # slice); a solve reads its rows' part (``elim``)
            vl = full_rows(p.data, p.data.edges[name].vidx[:, ls]).cpu() \
                .numpy()
            elim = marg_np[lt][np.minimum(vl, len(marg_np[lt]) - 1)]
            aux["elim"][name] = torch.as_tensor(elim.astype(np.float64),
                                                dtype=dtype, device=dev)
        self.aux = aux
        eyes = {t: torch.eye(p.vertex_types[t].tangent_dim, dtype=dtype,
                             device=dev) for t in p.vertex_types}

        def slot_types(name, slots):
            et = p.edge_types[name]
            return [(s, et.vertex_types[s].name) for s in slots]

        def elim(data, aux, name):
            """The eliminated-landmark mask of the rows ``data`` holds."""
            lo, n = row_window(data, name)
            return aux["elim"][name][lo:lo + n]

        def landmark_system(data, lin, lam, aux):
            """``ctx``: the eliminated-block inverses (damped diagonal on
            marginalized rows, unit elsewhere — unused there: the
            back-substitution masks them), one B block per (observation
            batch, pose slot), and ``b`` split per type."""
            Dfull = _damped_diag(p, data, lin, lam, lm_types)
            Dinv = {}
            for t in lm_types:
                if partial[t]:
                    mu = aux["marg"][t][:, None, None]
                    Dinv[t] = inv_small(Dfull[t] * mu
                                        + eyes[t] * (1.0 - mu))
                else:
                    Dinv[t] = inv_small(Dfull[t])
            B = {}
            for name, pslots, ls in obs_specs:
                Js = p.edge_jacs(lin, name)
                WJl = torch.einsum("ers,esf->erf", p.edge_weights(lin, name),
                                   Js[ls])
                B[name] = {s: torch.einsum("erd,erf->edf", Js[s], WJl)
                           for s in pslots}
            ball = p.split_tangent(lin.b)
            return dict(Dinv=Dinv, B=B, ball=ball,
                        bl={t: ball[t] for t in lm_types})

        def reduced_rhs(ctx, data, lin, aux):
            """``bschur`` over the retained system: ``b`` of the kept rows
            minus ``Σ_s B_s Dinv bl`` over eliminated landmarks."""
            ball = ctx["ball"]
            y = _apply_blocks(ctx["Dinv"], ctx["bl"], lm_types)
            bschur = {t: replicated_part(
                data, ball[t] * (1.0 - aux["marg"][t][:, None])
                if t in lm_types else ball[t]) for t in cg_types}
            for name, pslots, ls in obs_specs:
                vidx = data.edges[name].vidx
                el = elim(data, aux, name)[:, None]
                yl = y[lt_of[name]][vidx[:, ls]]
                for s, ts in slot_types(name, pslots):
                    bschur[ts] = bschur[ts].index_add(
                        0, vidx[:, s], el * torch.einsum(
                            "edl,el->ed", ctx["B"][name][s], yl), alpha=-1)
            edge_sum_(data, *bschur.values())
            return bschur

        def preconditioner(ctx, data, lin, lam, aux):
            """``(diag_blocks, minv)``: the damped diagonal blocks of the
            retained system (unit on eliminated rows of a partial type) and
            the inverses of the preconditioner blocks."""
            diag_blocks = _damped_diag(p, data, lin, lam, cg_types)
            for t in cg_types:
                if t in lm_types:
                    mu = aux["marg"][t][:, None, None]
                    diag_blocks[t] = (diag_blocks[t] * (1.0 - mu)
                                      + eyes[t] * mu)
            sdiag = dict(diag_blocks)
            if use_schur_precond:
                sdiag = {t: replicated_part(data, v)
                         for t, v in diag_blocks.items()}
                for name, pslots, ls in obs_specs:
                    vidx = data.edges[name].vidx
                    el = elim(data, aux, name)[:, None, None]
                    Dl = ctx["Dinv"][lt_of[name]][vidx[:, ls]]
                    for s, ts in slot_types(name, pslots):
                        Bs = ctx["B"][name][s]
                        C = torch.einsum("edl,elm,efm->edf", Bs, Dl, Bs)
                        sdiag[ts] = sdiag[ts].index_add(0, vidx[:, s], el * C,
                                                        alpha=-1)
                edge_sum_(data, *sdiag.values())
            return diag_blocks, {t: inv_small(sdiag[t]) for t in cg_types}

        def schur_rows(ctx, data, vb):
            """``Σ_s B_sᵀ v[slot s]`` per observation row, masked to the
            eliminated rows, summed per landmark: ``{landmark type: (N,
            dl)}``."""
            tl = {t: torch.zeros_like(ctx["bl"][t]) for t in lm_types}
            for name, pslots, ls in obs_specs:
                vidx = data.edges[name].vidx
                acc = None
                for s, ts in slot_types(name, pslots):
                    h = torch.einsum("edl,ed->el", ctx["B"][name][s],
                                     vb[ts][vidx[:, s]])
                    acc = h if acc is None else acc + h
                if acc is not None:          # unary landmark priors: none
                    tl[lt_of[name]] = tl[lt_of[name]].index_add(
                        0, vidx[:, ls], elim(data, aux, name)[:, None] * acc)
            edge_sum_(data, *tl.values())
            return tl

        def S_vec(ctx, data, lin, diag_blocks, vb):
            """``S·v`` over the retained system (completed over the
            processes of sharded data: the diagonal term on the first
            process only, the edge terms of each process's rows)."""
            out = {t: replicated_part(data, v) for t, v in _apply_blocks(
                diag_blocks, vb, cg_types).items()}
            for name in pose_edge_types:
                Js = p.edge_jacs(lin, name)
                out = _pair_couplings(out, p.edge_types[name],
                                      data.edges[name].vidx, Js,
                                      p.edge_weights(lin, name),
                                      range(len(Js)), vb)
            for name, pslots, ls in obs_specs:
                lt = lt_of[name]
                vidx = data.edges[name].vidx
                # (a) the pose-slot pair couplings, of every row: they stay
                # in the retained system whether or not the landmark goes
                out = _pair_couplings(out, p.edge_types[name], vidx,
                                      p.edge_jacs(lin, name),
                                      p.edge_weights(lin, name), pslots, vb)
                # (b) a retained landmark's couplings (non-eliminated rows)
                if lt in cg_types:
                    keep = 1.0 - elim(data, aux, name)[:, None]
                    vl = vb[lt][vidx[:, ls]]
                    accl = None
                    for s, ts in slot_types(name, pslots):
                        Bs = ctx["B"][name][s]
                        out[ts] = out[ts].index_add(0, vidx[:, s], keep * (
                            torch.einsum("edl,el->ed", Bs, vl)))
                        hl = torch.einsum("edl,ed->el", Bs, vb[ts][vidx[:, s]])
                        accl = hl if accl is None else accl + hl
                    if accl is not None:
                        out[lt] = out[lt].index_add(0, vidx[:, ls],
                                                    keep * accl)
            # (c) the Schur term − Σ_s B_s Dinv (Σ_s' B_s'ᵀ v) over the
            # eliminated rows
            s_ = _apply_blocks(ctx["Dinv"], schur_rows(ctx, data, vb),
                               lm_types)
            for name, pslots, ls in obs_specs:
                vidx = data.edges[name].vidx
                el = elim(data, aux, name)[:, None]
                sl = s_[lt_of[name]][vidx[:, ls]]
                for s, ts in slot_types(name, pslots):
                    out[ts] = out[ts].index_add(0, vidx[:, s], el * (
                        torch.einsum("edl,el->ed", ctx["B"][name][s], sl)),
                        alpha=-1)
            edge_sum_(data, *out.values())
            return out

        def cg(ctx, data, lin, bschur, diag_blocks, minv, aux, carry=None):
            """PCG on the retained system; ``(dxp, stats)``."""
            return _pcg(lambda v: S_vec(ctx, data, lin, diag_blocks, v),
                        lambda rb: _apply_blocks(minv, rb, cg_types),
                        _unprojected, bschur, cg_types, self.tol,
                        self.max_iter, carry)

        def back_substitute(ctx, data, lin, dxp, aux):
            """The eliminated rows ``Dinv (bl − Σ B_sᵀ dxp)`` joined with
            the retained ones into the full update."""
            bl, Dinv = ctx["bl"], ctx["Dinv"]
            wl = schur_rows(ctx, data, dxp)
            out = {t: torch.einsum("nij,nj->ni", Dinv[t], bl[t] - wl[t])
                   for t in full_lm}
            for t in cg_types:
                if t in lm_types:     # partial: retained + eliminated rows
                    mu = aux["marg"][t][:, None]
                    out[t] = dxp[t] * (1.0 - mu) + mu * torch.einsum(
                        "nij,nj->ni", Dinv[t], bl[t] - wl[t])
                else:
                    out[t] = dxp[t]
            return p.join_tangent(out)

        return self._finish(p, dict(
            landmark_system=landmark_system, reduced_rhs=reduced_rhs,
            preconditioner=preconditioner, cg=cg,
            back_substitute=back_substitute), dict(
            bucketed=False, form="general", buckets={}, slab_rows={}))

    def _finish(self, problem, parts, layout):
        """Bind the stages into one solve and reset the carried state."""
        def solve_full(data, lin, lam, aux=(), carry=None):
            """One solve: ``(dx, stats)`` with the CG iteration count and
            the final residual (the reference's iterationsLinearSolver
            statistic, ``g2o/core/batch_stats.h:59``)."""
            with span("schur_implicit.solve"):
                with span("schur_implicit.landmark_system"):
                    ctx = parts["landmark_system"](data, lin, lam, aux)
                with span("schur_implicit.reduced_rhs"):
                    bschur = parts["reduced_rhs"](ctx, data, lin, aux)
                with span("schur_implicit.preconditioner"):
                    diag_blocks, minv = parts["preconditioner"](
                        ctx, data, lin, lam, aux)
                with span("schur_implicit.cg"):
                    dxp, stats = parts["cg"](ctx, data, lin, bschur,
                                             diag_blocks, minv, aux, carry)
                with span("schur_implicit.back_substitute"):
                    dx = parts["back_substitute"](ctx, data, lin, dxp, aux)
            return dx, stats

        self._solve_full = solve_full
        # each stage alone, for per-layer timing
        self._parts = parts
        self._layout = layout
        self.state0 = (torch.tensor(-1.0, dtype=problem.dtype,
                                    device=problem.device)
                       if self.absolute_tolerance else None)
        self._host_state = None
        self._setup_for = problem
        return self

    def _solve_fn(self, data, lin, lam, aux=()):
        return self._solve_full(data, lin, lam, aux or self.aux)[0]

    def _solve_state_fn(self, data, lin, lam, state):
        """The stateful protocol of the LM loops: ``(dx, state', stats)``;
        the state is the carried residual floor when ``absolute_tolerance``
        is on (``state0 = -1``: no floor yet), else passed through."""
        carry = state if self.absolute_tolerance else None
        dx, st = self._solve_full(data, lin, lam, self.aux, carry)
        return dx, (st["carry"] if self.absolute_tolerance else state), st

    def solve(self, data, lin, lam=0.0):
        """One solve; carries the residual floor across calls when
        ``absolute_tolerance`` is on."""
        if self.absolute_tolerance:
            if self._host_state is None:
                self._host_state = self.state0
            dx, self._host_state, _ = self._solve_state_fn(
                data, lin, lam, self._host_state)
            return dx
        return self._solve_fn(data, lin, lam)
