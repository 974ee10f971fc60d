"""Explicit Schur-complement linear solver for bundle adjustment — port of
``g2o_tpu/core/solvers/schur.py`` (reference ``BlockSolver::solve``,
``g2o/core/block_solver.hpp:315-447``, with a dense reduced system).

* the per-landmark ``Dinv = Hll_j⁻¹`` loop (``:350``) is one batched
  closed-form inverse over all landmark blocks;
* the accumulation ``Hschur_ik -= (B_i Dinv) B_kᵀ`` (``:381-391``) is one
  batched product over a host-built pair list (every ordered pair of
  observations of one landmark), summed per unique camera-block pair by the
  segment sum K4 (``use_pallas=True``; ``ops/segment_kernels.py``) or its
  plain ``index_add_`` version, then added into the dense reduced camera
  matrix;
* the reduced system is factored with ``torch.linalg.cholesky_ex`` (the
  analogue of handing ``Hschur`` to CHOLMOD, ``:408``); a factor that is
  not positive definite becomes NaN, so the LM trial is rejected;
* landmark back-substitution ``xl = Dinv (bl − Bᵀ xp)`` (``:420-443``) is an
  ``index_add_`` and a batched product.

Vertices marked ``marginalized`` are eliminated.  Marginalization must be
homogeneous per vertex type; observation edges must be binary (pose type,
landmark type); all landmark types share one tangent dim and all
observation pose slots one dim.

Several processes (``mesh``, a ``torch.distributed`` device mesh, and/or
sharded data, ``ProblemData.group``): the pair batch is padded to the
mesh's size with masked pairs and each process takes one contiguous slice
of it; every process gathers the B blocks of all observations (one
all-reduce of a zeroed full buffer, since a pair may join observations held
by two processes), sums its pairs per camera-block pair with K4, and one
all-reduce completes the ``(n_uniq, dp²)`` sums.  The camera blocks of
pose-pose edges on sharded data are completed the same way; the rest of the
reduced system is replicated, so every process factors the same matrix.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from g2o_tpu_torch.core.problem import (all_reduce_sum_, edge_sum_,
                                        full_rows, shard_rank)
from g2o_tpu_torch.core.solvers.dense import cholesky_solve_or_nan
from g2o_tpu_torch.ops.segment_kernels import segment_sum, segment_sum_plain
from g2o_tpu_torch.ops.smallblocks import inv_small
from g2o_tpu_torch.utils.tictoc import span


def _observation_pairs(obs_lm):
    """All ordered pairs ``(a, b)`` of observations that share a landmark,
    landmark by landmark in ascending id, ``a``-major within one landmark
    (the JAX package's ``meshgrid(grp, grp, indexing="ij")`` order)."""
    order = np.argsort(obs_lm, kind="stable")
    if len(order) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    s = obs_lm[order]
    starts = np.flatnonzero(np.r_[True, s[1:] != s[:-1]])
    sizes = np.diff(np.r_[starts, len(order)])
    gsize = np.repeat(sizes, sizes)           # group size at each position
    gstart = np.repeat(starts, sizes)         # group start at each position
    pos_a = np.repeat(np.arange(len(order)), gsize)
    within = np.arange(len(pos_a)) - np.repeat(np.cumsum(gsize) - gsize, gsize)
    pos_b = np.repeat(gstart, gsize) + within
    return order[pos_a], order[pos_b]


class SchurSolver:
    name = "schur"

    def __init__(self, use_cholesky: bool = True, mesh=None,
                 use_pallas: bool | None = None):
        """``use_pallas=True`` sums the pair products with the K4 kernel on
        a CUDA tensor (the JAX package's Pallas switch); otherwise with the
        plain ``index_add_`` route.  ``mesh`` (a ``torch.distributed``
        device mesh, ``g2o_tpu_torch.parallel.make_mesh``) splits the pair
        batch over its processes (module docstring)."""
        self.use_cholesky = bool(use_cholesky)
        self.mesh = mesh
        self.use_pallas = bool(use_pallas) if use_pallas is not None else False
        self._setup_for = None

    # ------------------------------------------------------------------ #

    def setup(self, problem, force: bool = False):
        """Build the host-side index maps for ``problem`` (a no-op when
        called again for the same problem)."""
        if self._setup_for is problem and not force:
            return self
        p = problem
        dev, dtype = p.device, p.dtype
        marg = {t: bool(m.all()) for t, m in p.marginalized.items()}
        for t, m in p.marginalized.items():
            if m.any() and not m.all():
                raise NotImplementedError(
                    f"SchurSolver: vertex type {t} is partially "
                    "marginalized — use ImplicitSchurSolver, whose general "
                    "path supports per-vertex marginalization and n-ary "
                    "observation edges exactly")
        lm_types = [t for t, v in marg.items() if v]
        pose_types = [t for t, v in marg.items() if not v]
        if not lm_types:
            raise ValueError("SchurSolver: no marginalized vertices")
        lm_dims = {p.vertex_types[t].tangent_dim for t in lm_types}
        if len(lm_dims) != 1:
            raise NotImplementedError("mixed landmark tangent dims")
        (dl,) = lm_dims

        # pose-only flat layout and landmark linear index
        pose_base, base = {}, 0
        for t in pose_types:
            pose_base[t] = base
            base += p.counts[t] * p.vertex_types[t].tangent_dim
        Tp = base
        lm_base, NL = {}, 0
        for t in lm_types:
            lm_base[t] = NL
            NL += p.counts[t]
        pose_off = {t: pose_base[t] + np.arange(p.counts[t], dtype=np.int64)
                    * p.vertex_types[t].tangent_dim for t in pose_types}
        fixed = {t: p.data.fixed[t].cpu().numpy() for t in p.vertex_types}
        pose_fixed_flat = np.concatenate(
            [np.repeat(fixed[t], p.vertex_types[t].tangent_dim)
             for t in pose_types] or [np.zeros(0)]).astype(np.float64)

        # classify edge types
        obs_specs, pose_edge_types, obs_pose_dims = [], [], set()
        for name, et in p.edge_types.items():
            slots_marg = [marg[vt.name] for vt in et.vertex_types]
            if not any(slots_marg):
                pose_edge_types.append(name)
                continue
            if len(slots_marg) != 2 or all(slots_marg):
                raise NotImplementedError(
                    f"SchurSolver: edge type {name} connects landmarks in an "
                    f"unsupported pattern")
            lm_slot = slots_marg.index(True)
            obs_specs.append((name, 1 - lm_slot, lm_slot))
            obs_pose_dims.add(et.vertex_types[1 - lm_slot].tangent_dim)
        if len(obs_pose_dims) > 1:
            raise NotImplementedError("mixed pose tangent dims in observations")
        dp = obs_pose_dims.pop() if obs_pose_dims else 0

        # concatenated observations: pose flat offset, landmark linear index
        # (every observation, also where this process holds a row slice)
        obs_cam, obs_lm = [], []
        for name, ps, ls in obs_specs:
            et = p.edge_types[name]
            vidx = full_rows(p.data, p.data.edges[name].vidx).cpu().numpy()
            obs_cam.append(pose_off[et.vertex_types[ps].name][vidx[:, ps]])
            obs_lm.append(lm_base[et.vertex_types[ls].name] + vidx[:, ls])
        obs_cam = np.concatenate(obs_cam) if obs_cam else np.zeros(0, np.int64)
        obs_lm = np.concatenate(obs_lm) if obs_lm else np.zeros(0, np.int64)

        # the Schur pattern: pairs grouped by (camera-block row, column), so
        # their products are summed into <= (#cam blocks)² unique blocks
        # before touching the dense matrix (the analogue of writing into the
        # Hschur block pattern, ``block_solver.hpp:381-391``).  The pairs
        # are sorted by that group once here, so K4 sees long runs of one
        # id; this changes only the summation order.
        pairs_a, pairs_b = _observation_pairs(obs_lm)
        key = (obs_cam[pairs_a] << 32) | obs_cam[pairs_b]
        uniq, pair_seg = np.unique(key, return_inverse=True)
        srt = np.argsort(pair_seg, kind="stable")
        pairs_a, pairs_b, pair_seg = pairs_a[srt], pairs_b[srt], pair_seg[srt]
        n_uniq = len(uniq)
        uniq_row, uniq_col = uniq >> 32, uniq & 0xFFFFFFFF
        n_pairs = len(pairs_a)
        pair_group, pair_valid = None, None
        if self.mesh is not None:
            # this process's slice of the pair batch, padded to the mesh's
            # size with masked pairs (at the last id: the ids stay sorted)
            from g2o_tpu_torch.parallel.sharded import mesh_group

            pair_group = mesh_group(self.mesh)
            rank = dist.get_rank(pair_group)
            world = dist.get_world_size(pair_group)
            per = -(-n_pairs // world)
            n_pad = per * world - n_pairs
            last = max(n_uniq - 1, 0)
            pairs_a, pairs_b, pair_seg = (
                np.concatenate([x, np.full(n_pad, fill, np.int64)])
                [rank * per:(rank + 1) * per]
                for x, fill in ((pairs_a, 0), (pairs_b, 0),
                                (pair_seg, last)))
            pair_valid = (np.arange(rank * per, (rank + 1) * per)
                          < n_pairs).astype(np.float64)

        # landmark global tangent offsets; pose flat -> global offsets
        lm_goff = np.concatenate([p.data.offsets[t].cpu().numpy()
                                  for t in lm_types])
        pose_to_global = np.concatenate(
            [(p.data.offsets[t].cpu().numpy()[:, None]
              + np.arange(p.vertex_types[t].tangent_dim)).reshape(-1)
             for t in pose_types] or [np.zeros(0, np.int64)])
        lm_fixed = np.concatenate([fixed[t] for t in lm_types])

        ar_p, ar_l = np.arange(dp), np.arange(dl)

        def block_flat(rows, cols, d):
            """Flat ``(n, d, d)`` indices of the d×d blocks at (row, col)
            offsets of the dense (Tp, Tp) matrix."""
            r = rows[:, None] + np.arange(d)
            c = cols[:, None] + np.arange(d)
            return r[:, :, None] * Tp + c[:, None, :]

        def ten(x, dt=torch.int64):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=dt,
                                   device=dev)

        self.aux = dict(
            obs_lm=ten(obs_lm),
            cam_idx2=ten(obs_cam[:, None] + ar_p),             # (Eo, dp)
            lm_idx2=ten(lm_goff[:, None] + ar_l),              # (NL, dl)
            pairs_a=ten(pairs_a), pairs_b=ten(pairs_b),
            pair_seg=ten(pair_seg, torch.int32),               # K4 ids
            uniq_flat=ten(block_flat(uniq_row, uniq_col, dp).reshape(-1)),
            pose_off={t: ten(o) for t, o in pose_off.items()},
            pose_diag_flat={t: ten(block_flat(
                o, o, p.vertex_types[t].tangent_dim).reshape(-1))
                for t, o in pose_off.items()},
            pose_to_global=ten(pose_to_global),
            pose_fixed_flat=ten(pose_fixed_flat, dtype),
            lm_fixed=ten(lm_fixed, dtype),
        )
        if pair_valid is not None:
            self.aux["pair_valid"] = ten(pair_valid, dtype)
        eye_l = torch.eye(dl, dtype=dtype, device=dev)

        def build_B(data, lin):
            """Per-observation Hessian off-diagonal blocks B = Jpᵀ W Jl, of
            every observation (gathered from the processes of sharded
            data)."""
            Bs = [full_rows(data, torch.einsum(
                "erd,ers,esf->edf", p.edge_jacs(lin, name)[ps],
                p.edge_weights(lin, name), p.edge_jacs(lin, name)[ls]))
                  for name, ps, ls in obs_specs]
            return torch.cat(Bs) if Bs else torch.zeros(
                (0, dp, dl), dtype=dtype, device=dev)

        def landmark_dinv(lin, lam, aux):
            """Inverses of the damped landmark blocks (unit on fixed ones)."""
            D = torch.cat([lin.diag[t] for t in lm_types]) + lam * eye_l
            fx = aux["lm_fixed"][:, None, None]
            return inv_small(D * (1.0 - fx) + eye_l * fx)

        def build_Hpp(data, lin, lam, aux):
            """The dense damped camera block ``Hpp + λI`` (unit diagonal on
            fixed camera slots).  On sharded data the pose-pose edges' blocks
            are this process's rows, completed by one all-reduce (the
            replicated diagonal blocks added on the first process only)."""
            H = torch.zeros(Tp * Tp, dtype=dtype, device=dev)
            reduce = data.group is not None and bool(pose_edge_types)
            if not reduce or shard_rank(data)[0] == 0:
                for t in pose_types:
                    H.index_add_(0, aux["pose_diag_flat"][t],
                                 lin.diag[t].reshape(-1))
            for name in pose_edge_types:
                et = p.edge_types[name]
                vidx = data.edges[name].vidx
                Js, W = p.edge_jacs(lin, name), p.edge_weights(lin, name)
                idxs = [aux["pose_off"][vt.name][vidx[:, s]][:, None]
                        + torch.arange(vt.tangent_dim, device=dev)
                        for s, vt in enumerate(et.vertex_types)]
                for i in range(len(Js)):
                    WJi = torch.einsum("ers,erd->esd", W, Js[i])
                    for j in range(i + 1, len(Js)):
                        Hij = torch.einsum("esd,esf->edf", WJi, Js[j])
                        for a, b, blk in ((i, j, Hij),
                                          (j, i, Hij.transpose(1, 2))):
                            flat = (idxs[a][:, :, None] * Tp
                                    + idxs[b][:, None, :])
                            H.index_add_(0, flat.reshape(-1),
                                         blk.reshape(-1))
            if reduce:
                edge_sum_(data, H)
            H = H.reshape(Tp, Tp)
            H.diagonal().add_(aux["pose_fixed_flat"] + lam)
            return H

        def pair_products(B, Dinv, aux):
            """``M_p = (B_a Dinv) B_bᵀ`` for every pair of this process,
            ``(P, dp·dp)`` (padding pairs zero)."""
            BD = torch.bmm(B, Dinv[aux["obs_lm"]])
            M = torch.bmm(BD[aux["pairs_a"]], B[aux["pairs_b"]].transpose(1, 2))
            M = M.reshape(-1, dp * dp)
            if "pair_valid" in aux:
                M = M * aux["pair_valid"][:, None]
            return M

        def aggregate(M, aux):
            """Sum the pair products per unique camera-block pair (K4), over
            the pairs of every process of the mesh."""
            if self.use_pallas:
                Mu = segment_sum(M, aux["pair_seg"], n_uniq)
            else:
                Mu = segment_sum_plain(M, aux["pair_seg"], n_uniq)
            all_reduce_sum_(pair_group, Mu)
            return Mu

        def reduced_parts(data, lin, lam, aux):
            """(Hschur, bschur, B, Dinv) — the dense reduced camera system
            plus the per-observation off-diagonal blocks and landmark block
            inverses."""
            with span("schur.reduce"):
                B = build_B(data, lin)                     # (Eo, dp, dl)
                Dinv = landmark_dinv(lin, lam, aux)
                bl = lin.b[aux["lm_idx2"]]                 # (NL, dl)
                y = torch.einsum("nij,nj->ni", Dinv, bl)   # Dinv · bl
                # bschur = bp − B·y, scattered over observations
                contrib = torch.einsum("edl,el->ed", B, y[aux["obs_lm"]])
                bschur = lin.b[aux["pose_to_global"]].index_add_(
                    0, aux["cam_idx2"].reshape(-1), contrib.reshape(-1),
                    alpha=-1)
                Hpp = build_Hpp(data, lin, lam, aux)
            # Hschur = Hpp − Σ_pairs B_a Dinv B_bᵀ, aggregated per unique
            # camera-block pair first
            with span("schur.pairs"):
                Mu = aggregate(pair_products(B, Dinv, aux), aux)
                Hschur = Hpp.reshape(-1).index_add_(
                    0, aux["uniq_flat"], Mu.reshape(-1),
                    alpha=-1).reshape(Tp, Tp)
            return Hschur, bschur, B, Dinv

        def factor_solve(Hschur, bschur):
            if self.use_cholesky:
                return cholesky_solve_or_nan(Hschur, bschur)
            x, info = torch.linalg.solve_ex(Hschur, bschur)
            return torch.where(info == 0, x, torch.nan)

        def back_substitute(lin, B, Dinv, dxp, aux):
            """``dxl = Dinv (bl − Bᵀ dxp)``, assembled with ``dxp`` into the
            full update."""
            bl = lin.b[aux["lm_idx2"]]
            w = torch.einsum("edl,ed->el", B, dxp[aux["cam_idx2"]])
            wl = torch.zeros_like(bl).index_add_(0, aux["obs_lm"], w)
            dxl = torch.einsum("nij,nj->ni", Dinv, bl - wl)
            dx = torch.zeros_like(lin.b)
            dx[aux["pose_to_global"]] = dxp
            dx[aux["lm_idx2"]] = dxl
            return dx

        def solve(data, lin, lam, aux):
            with span("schur.solve"):
                Hschur, bschur, B, Dinv = reduced_parts(data, lin, lam, aux)
                with span("schur.factor"):
                    dxp = factor_solve(Hschur, bschur)
                with span("schur.back_substitute"):
                    return back_substitute(lin, B, Dinv, dxp, aux)

        self._solve_fn = solve
        self._reduced_parts_fn = reduced_parts   # for marginals
        # each stage alone, for per-layer timing
        self._parts = dict(build_B=build_B, landmark_dinv=landmark_dinv,
                           build_Hpp=build_Hpp, pair_products=pair_products,
                           aggregate=aggregate, factor_solve=factor_solve,
                           back_substitute=back_substitute)
        # layout facts marginals needs to map vertex ids into the reduced
        # (pose-flat / landmark-linear) coordinates
        self._layout = dict(pose_base=pose_base, lm_base=lm_base, Tp=Tp,
                            NL=NL, dp=dp, dl=dl, marg=marg, n_pairs=len(
                                pairs_a), n_uniq=n_uniq)
        self._setup_for = problem
        return self

    def solve(self, data, lin, lam=0.0):
        return self._solve_fn(data, lin, lam, self.aux)
