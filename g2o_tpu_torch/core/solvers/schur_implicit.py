"""Implicit (matrix-free) Schur-complement solver for large bundle
adjustment — port of the binary-edge path of
``g2o_tpu/core/solvers/schur_implicit.py``.

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
Schur loop, ``block_solver.hpp:339-393``).  Three observation layouts:

* ``layout="rows"`` — row gathers and ``index_add_`` through each edge
  batch's ``vidx``;
* ``layout="bucketed"`` on a problem built WITHOUT ``bucket_landmarks`` —
  at setup the observations are planned into the landmark-degree buckets
  of ``g2o_tpu_torch/ops/bucketed.py`` (a host plan in ``aux``): the
  landmark side reduces per slab, the camera side gathers and sums with the
  row-major kernels of ``ops/onehot.py`` (padded slots carry the sentinel
  camera id ``N_cam``: zero on the gather, dropped by the sum);
* a problem built WITH ``bucket_landmarks=True`` (``layout="auto"`` picks
  it): fully DIMS-MAJOR (``dm``) — the off-diagonal blocks and the
  bucket-order landmark system come from the linearization's ``extras``,
  the camera side runs the dims-major gather and segment-sum kernels, and
  no landmark-axis index op is left in the CG body.

Preconditioners: ``"schur_jacobi"`` (default) — the per-camera diagonal
blocks of the REDUCED system, ``Hpp_jj − Σ B_e Dinv B_eᵀ``; ``"jacobi"`` —
the damped ``Hpp`` blocks.  ``deflate_basis`` (``{pose type: (N, d, k)}``,
orthonormal, e.g. :func:`g2o_tpu_torch.types.bal.bal_gauge_basis`) runs CG
on the orthogonal complement of the free-gauge null space.

The JAX package's ``lax.while_loop`` is a Python loop here: its stop test
reads one scalar from the device per CG iteration.  ``matvec_precision`` is
accepted for API parity: TF32 stays off, so every product is full
float32/float64.  The general path (n-ary observation edges, partial
marginalization) is not ported and raises.
"""

from __future__ import annotations

import numpy as np
import torch

from g2o_tpu_torch.ops.bucketed import bucket_by_segment
from g2o_tpu_torch.ops.onehot import (onehot_gather, onehot_gather_t,
                                      onehot_scatter_add,
                                      onehot_scatter_add_t)
from g2o_tpu_torch.ops.smallblocks import inv_small, inv_small_t


class ImplicitSchurSolver:
    name = "schur_implicit"

    def __init__(self, max_iter: int = 100, tol: float = 1e-8, *,
                 precond: str = "schur_jacobi", layout: str = "auto",
                 max_buckets: int = 10,
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
            vidx = p.data.edges[name].vidx.cpu().numpy()
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
        (lm_types, pose_types, obs_specs, pose_edge_types, _,
         general) = self._classify(p)
        if general:
            raise NotImplementedError(
                "ImplicitSchurSolver: n-ary observation edges and partial "
                "marginalization need the general path, which is not "
                "ported yet (ROADMAP A.6)")
        obs_specs = [(name, ps[0], ls) for name, ps, ls in obs_specs]
        dtype, dev = p.dtype, p.device
        max_iter, tol = self.max_iter, self.tol
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
        if bucketed:
            users = [lm_of[name] for name, _, _ in obs_specs]
            if len(set(users)) != len(users):
                raise NotImplementedError(
                    "ImplicitSchurSolver: the bucketed layouts of a landmark "
                    "type observed by several edge types are not ported yet "
                    "(use layout='rows')")

        # ---------------- host symbolic phase: bucket plans ------------- #
        bspec, aux = {}, {}
        if bucketed:
            for name, ps, ls in obs_specs:
                if pre[name]:
                    sp = p.bucket_specs[name]
                    bspec[name] = (sp.counts, sp.degrees, sp.n_rows)
                    continue
                vidx = p.data.edges[name].vidx.cpu().numpy()
                plan = bucket_by_segment(vidx[:, ls], p.counts[lm_of[name]],
                                         max_buckets=self.max_buckets)
                camz = np.concatenate([vidx[:, ps].astype(np.int64),
                                       [p.counts[pt_of[name]]]])
                cam_pad = camz[plan.perm_src]
                aux[name] = dict(
                    perm=torch.as_tensor(plan.perm_src.astype(np.int64),
                                         device=dev),
                    cam=torch.as_tensor(cam_pad.astype(np.int32), device=dev),
                    segp=torch.as_tensor(plan.seg_perm.astype(np.int64),
                                         device=dev))
                bspec[name] = (plan.counts, plan.degrees,
                               int(len(plan.perm_src)))
        if self.deflate_basis:
            aux["deflate_G"] = {
                t: torch.as_tensor(np.asarray(v), dtype=dtype, device=dev)
                for t, v in self.deflate_basis.items()}
        self.aux = aux

        def damped_diag(data, lin, lam, types):
            out = {}
            for t in types:
                d = p.vertex_types[t].tangent_dim
                eye = torch.eye(d, dtype=dtype, device=dev)
                fx = data.fixed[t].to(dtype)[:, None, None]
                out[t] = (lin.diag[t] + lam * eye) * (1.0 - fx) + eye * fx
            return out

        def pdot(a, b):
            return sum(torch.sum(a[t] * b[t]) for t in pose_types)

        # landmark side: per-bucket slabs, degree-major (deg, n_seg)
        def bucket_down(spec, B_pad, u_pad):
            """Σ_rows Bᵀu per segment, row-major: (S_used, dl)."""
            counts, degrees, _ = spec
            out, off = [], 0
            for n, d in zip(counts, degrees):
                Bb = B_pad[off:off + n * d].reshape((d, n) + B_pad.shape[1:])
                ub = u_pad[off:off + n * d].reshape((d, n) + u_pad.shape[1:])
                out.append(torch.einsum("dnij,dni->nj", Bb, ub))
                off += n * d
            return torch.cat(out, dim=0)

        def bucket_up(spec, B_pad, s_used):
            """B s_{segment(row)} per padded row, row-major: (E_pad, dp)."""
            counts, degrees, _ = spec
            out, off, k = [], 0, 0
            for n, d in zip(counts, degrees):
                Bb = B_pad[off:off + n * d].reshape((d, n) + B_pad.shape[1:])
                yb = torch.einsum("dnij,nj->dni", Bb, s_used[k:k + n])
                out.append(yb.reshape((n * d,) + yb.shape[2:]))
                off += n * d
                k += n
            return torch.cat(out, dim=0)

        def bucket_down_t(spec, Bt, ut):
            """Σ_rows Bᵀu, dims-major: Bt (dp, dl, E), ut (dp, E) ->
            (dl, S_used) in bucket order."""
            counts, degrees, _ = spec
            z = torch.sum(Bt * ut[:, None, :], dim=0)
            out, off = [], 0
            for n, d in zip(counts, degrees):
                out.append(z[:, off:off + n * d].reshape(
                    z.shape[0], d, n).sum(dim=1))
                off += n * d
            return torch.cat(out, dim=1)

        def bucket_broadcast_t(spec, x):
            """Per-segment ``(..., S_used)`` -> padded rows ``(..., E)``."""
            counts, degrees, _ = spec
            parts, off = [], 0
            for n, d in zip(counts, degrees):
                xb = x[..., off:off + n]
                parts.append(xb[..., None, :].expand(
                    xb.shape[:-1] + (d, n)).reshape(xb.shape[:-1] + (n * d,)))
                off += n
            return torch.cat(parts, dim=-1)

        def bucket_up_t(spec, Bt, st):
            """B s per row, dims-major: st (dl, S_used) -> (dp, E)."""
            return torch.sum(Bt * bucket_broadcast_t(spec, st)[None], dim=1)

        def cam_of(data, name, ps):
            """The camera ids (int32) of each slab row of batch ``name``."""
            if pre[name]:
                return data.plans[name]["ids32"][ps, :bspec[name][2]]
            return aux[name]["cam"]

        def segp_of(data, name):
            return (data.plans[name]["segp"] if pre[name]
                    else aux[name]["segp"])

        def seg_ident(name):
            return pre[name] and p.bucket_specs[name].seg_identity

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

        # ------------------------------------------------------------------ #
        # per-λ-trial stages
        # ------------------------------------------------------------------ #

        def landmark_system(data, lin, lam, aux):
            """Landmark inverses and off-diagonal blocks: a dict ``ctx``
            the later stages read.  The ``dm`` batches take B and their
            bucket-order landmark system from the linearization's extras;
            the others build B = Jpᵀ W Jl dims-major from the Jacobians."""
            ext = lin.extras or {}
            dm = {name: bucketed and pre[name] for name, _, _ in obs_specs}
            dm_lm = {lm_of[name] for name, _, _ in obs_specs if dm[name]}
            Dinv = {t: inv_small(D) for t, D in damped_diag(
                data, lin, lam, [t for t in lm_types if t not in dm_lm]).items()}
            Bt_s, Dinv_t, bl_bt = {}, {}, {}
            for name, ps, ls in obs_specs:
                if not dm[name]:
                    continue
                d = p.vertex_types[lm_of[name]].tangent_dim
                Bt_s[name] = ext[name]["Bt"][:, :, :bspec[name][2]]
                bl_bt[name] = ext[name]["bl_bucket_t"]            # (d, S)
                Hll_t = ext[name]["Hll_bucket_t"].reshape(d, d, -1)
                eye_t = torch.eye(d, dtype=dtype, device=dev)[:, :, None]
                # all-zero blocks are fixed landmarks (their Jacobian slots
                # are masked at linearize): a unit block, dx = 0
                zero = (Hll_t == 0).all(dim=0).all(dim=0)[None, None, :]
                Dinv_t[name] = inv_small_t(
                    torch.where(zero, eye_t, Hll_t + lam * eye_t))
            B, Bt = {}, {}
            for name, ps, ls in obs_specs:
                if dm[name]:
                    continue
                Js, W = lin.jacs[name], lin.weights[name]
                if name in p.bucket_specs:       # dims-major leaves already
                    Jpt, Jlt, Wt = Js[ps], Js[ls], W
                else:
                    Jpt = Js[ps].permute(1, 2, 0)            # (r, dp, E)
                    Jlt = Js[ls].permute(1, 2, 0)            # (r, dl, E)
                    Wt = W.permute(1, 2, 0)                  # (r, s, E)
                WJl = torch.sum(Wt[:, :, None, :] * Jlt[None], dim=1)
                Bt[name] = torch.sum(Jpt[:, :, None, :] * WJl[:, None],
                                     dim=0)                  # (dp, dl, E)
                B[name] = Bt[name].permute(2, 0, 1)
            ctx = dict(dm=dm, dm_lm=dm_lm, Dinv=Dinv, Bt_s=Bt_s,
                       Dinv_t=Dinv_t, bl_bt=bl_bt, B=B)
            if bucketed:
                # B in slab order once per solve (sentinel row E is zero);
                # dims-major copies for the CG body
                Bp, Bpt, Dinv_perm, DinvT_perm = {}, {}, {}, {}
                for name, ps, ls in obs_specs:
                    if dm[name]:
                        continue
                    Bz = torch.cat([B[name], B[name].new_zeros(
                        (1,) + tuple(B[name].shape[1:]))])
                    Bp[name] = Bz[aux[name]["perm"]]
                    Bpt[name] = Bp[name][:bspec[name][2]].permute(1, 2, 0)
                    Dinv_perm[name] = seg_take(data, name, Dinv[lm_of[name]])
                    DinvT_perm[name] = Dinv_perm[name].permute(1, 2, 0)
                ctx.update(Bp=Bp, Bpt=Bpt, Dinv_perm=Dinv_perm,
                           DinvT_perm=DinvT_perm)
            ball = p.split_tangent(lin.b)
            ctx["bl"] = {t: ball[t] for t in lm_types}
            ctx["bp"] = {t: ball[t] for t in pose_types}
            return ctx

        def reduced_rhs(ctx, data, lin, aux):
            """``bschur = bp − B · (Dinv bl)``."""
            Dinv, bl = ctx["Dinv"], ctx["bl"]
            y = {t: torch.einsum("nij,nj->ni", Dinv[t], bl[t])
                 for t in lm_types if t not in ctx["dm_lm"]}
            bschur = dict(ctx["bp"])
            for name, ps, ls in obs_specs:
                pt, lt = pt_of[name], lm_of[name]
                if ctx["dm"][name]:
                    y_bt = torch.einsum("ijn,jn->in", ctx["Dinv_t"][name],
                                        ctx["bl_bt"][name])
                    rows_t = bucket_up_t(bspec[name], ctx["Bt_s"][name], y_bt)
                    bschur[pt] = bschur[pt] - onehot_scatter_add_t(
                        cam_of(data, name, ps), rows_t, p.counts[pt])
                elif bucketed:
                    rows = bucket_up(bspec[name], ctx["Bp"][name],
                                     seg_take(data, name, y[lt]))
                    bschur[pt] = bschur[pt] - onehot_scatter_add(
                        cam_of(data, name, ps), rows, p.counts[pt])
                else:
                    vidx = data.edges[name].vidx
                    bschur[pt] = bschur[pt].index_add(
                        0, vidx[:, ps], torch.einsum(
                            "edl,el->ed", ctx["B"][name], y[lt][vidx[:, ls]]),
                        alpha=-1)
            return bschur

        def preconditioner(ctx, data, lin, lam, aux):
            """``(diag_blocks, minv)``: the damped Hpp blocks and the
            inverses of the preconditioner blocks (``schur_jacobi``: the
            reduced system's camera blocks).  Fixed cameras keep their unit
            blocks: their B rows are zero."""
            diag_blocks = damped_diag(data, lin, lam, pose_types)
            sdiag = dict(diag_blocks)
            if use_schur_precond:
                for name, ps, ls in obs_specs:
                    pt, lt = pt_of[name], lm_of[name]
                    if ctx["dm"][name]:
                        # C = B Dinv Bᵀ per row, dims-major
                        Bts = ctx["Bt_s"][name]
                        dp_ = Bts.shape[0]
                        Drows = bucket_broadcast_t(bspec[name],
                                                   ctx["Dinv_t"][name])
                        T_ = torch.sum(Bts[:, :, None, :] * Drows[None],
                                       dim=1)
                        C_t = torch.sum(T_[:, None, :, :] * Bts[None], dim=2)
                        sdiag[pt] = sdiag[pt] - onehot_scatter_add_t(
                            cam_of(data, name, ps), C_t.reshape(dp_ * dp_, -1),
                            p.counts[pt]).reshape(-1, dp_, dp_)
                    elif bucketed:
                        counts, degrees, _ = bspec[name]
                        Dp, off, k, rows = ctx["Dinv_perm"][name], 0, 0, []
                        for n, d in zip(counts, degrees):
                            Bb = ctx["Bp"][name][off:off + n * d]
                            Bb = Bb.reshape((d, n) + Bb.shape[1:])
                            Cb = torch.einsum("dnij,njk,dnlk->dnil",
                                              Bb, Dp[k:k + n], Bb)
                            rows.append(Cb.reshape((n * d,) + Cb.shape[2:]))
                            off += n * d
                            k += n
                        sdiag[pt] = sdiag[pt] - onehot_scatter_add(
                            cam_of(data, name, ps), torch.cat(rows),
                            p.counts[pt])
                    else:
                        vidx = data.edges[name].vidx
                        Bn = ctx["B"][name]
                        C = torch.einsum("edl,elm,efm->edf", Bn,
                                         ctx["Dinv"][lt][vidx[:, ls]], Bn)
                        sdiag[pt] = sdiag[pt].index_add(0, vidx[:, ps], C,
                                                        alpha=-1)
            return diag_blocks, {t: inv_small(sdiag[t]) for t in pose_types}

        def S_vec(ctx, data, lin, diag_blocks, vb):
            """The reduced-system product ``S·v`` in block layout."""
            out = {t: torch.einsum("nij,nj->ni", diag_blocks[t], vb[t])
                   for t in pose_types}
            # pose-pose edges: the off-diagonal Hpp couplings
            for name in pose_edge_types:
                et = p.edge_types[name]
                vidx = data.edges[name].vidx
                Js, W = p.edge_jacs(lin, name), p.edge_weights(lin, name)
                for i in range(len(Js)):
                    ti = et.vertex_types[i].name
                    acc = None
                    for j in range(len(Js)):
                        if i == j:
                            continue
                        tj = et.vertex_types[j].name
                        h = torch.einsum("erd,ers,esf,ef->ed", Js[i], W, Js[j],
                                         vb[tj][vidx[:, j]])
                        acc = h if acc is None else acc + h
                    if acc is not None:
                        out[ti] = out[ti].index_add(0, vidx[:, i], acc)
            # the Schur term − B Dinv Bᵀ v
            if bucketed:
                for name, ps, ls in obs_specs:
                    pt = pt_of[name]
                    ids = cam_of(data, name, ps)
                    if ctx["dm"][name]:
                        Bts = ctx["Bt_s"][name]
                        u_t = onehot_gather_t(ids, vb[pt])
                        t_ = bucket_down_t(bspec[name], Bts, u_t)
                        s_t = torch.sum(ctx["Dinv_t"][name] * t_[None],
                                        dim=1)
                        rows_t = bucket_up_t(bspec[name], Bts, s_t)
                        out[pt] = out[pt] - onehot_scatter_add_t(
                            ids, rows_t, p.counts[pt])
                        continue
                    Bpt = ctx["Bpt"][name]
                    u = onehot_gather(ids, vb[pt])
                    t_ = bucket_down_t(bspec[name], Bpt, u.T)
                    s_t = torch.sum(ctx["DinvT_perm"][name] * t_[None], dim=1)
                    rows_t = bucket_up_t(bspec[name], Bpt, s_t)
                    out[pt] = out[pt] - onehot_scatter_add(
                        ids, rows_t.T.contiguous(), p.counts[pt])
                return out
            tl = {t: torch.zeros((p.counts[t], p.vertex_types[t].tangent_dim),
                                 dtype=dtype, device=dev) for t in lm_types}
            for name, ps, ls in obs_specs:
                vidx = data.edges[name].vidx
                tl[lm_of[name]].index_add_(0, vidx[:, ls], torch.einsum(
                    "edl,ed->el", ctx["B"][name], vb[pt_of[name]][vidx[:, ps]]))
            s_ = {t: torch.einsum("nij,nj->ni", ctx["Dinv"][t], tl[t])
                  for t in lm_types}
            for name, ps, ls in obs_specs:
                vidx = data.edges[name].vidx
                pt = pt_of[name]
                out[pt] = out[pt].index_add(0, vidx[:, ps], torch.einsum(
                    "edl,el->ed", ctx["B"][name], s_[lm_of[name]][vidx[:, ls]]),
                    alpha=-1)
            return out

        def cg(ctx, data, lin, bschur, diag_blocks, minv, aux, carry=None):
            """PCG on the reduced system; ``(dxp, stats)``.  The stop test
            ``‖r‖² ≤ max(tol²‖b‖², carry)`` is read on the host once per
            iteration."""
            G = aux.get("deflate_G") if isinstance(aux, dict) else None

            def project(vb):
                if G is None:
                    return vb
                coef = sum(torch.einsum("ndk,nd->k", Gt, vb[t])
                           for t, Gt in G.items())
                out = dict(vb)
                for t, Gt in G.items():
                    out[t] = vb[t] - torch.einsum("ndk,k->nd", Gt, coef)
                return out

            def precond(rb):
                return {t: torch.einsum("nij,nj->ni", minv[t], rb[t])
                        for t in pose_types}

            x = {t: torch.zeros_like(bschur[t]) for t in pose_types}
            r = project(bschur)
            z = project(precond(r))
            pv, rz = z, pdot(r, z)
            rhs2 = pdot(bschur, bschur)
            thresh = tol * tol * rhs2
            if carry is not None:
                thresh = torch.maximum(thresh, carry.to(thresh.dtype))
            it = 0
            while it < max_iter and bool(pdot(r, r) > thresh):
                Ap = project(S_vec(ctx, data, lin, diag_blocks, pv))
                alpha = rz / pdot(pv, Ap)
                x = {t: x[t] + alpha * pv[t] for t in pose_types}
                r = {t: r[t] - alpha * Ap[t] for t in pose_types}
                z = project(precond(r))
                rz2 = pdot(r, z)
                pv = {t: z[t] + (rz2 / rz) * pv[t] for t in pose_types}
                rz = rz2
                it += 1
            res2 = pdot(r, r)
            return x, {"cg_iterations": it, "residual2": res2, "rhs2": rhs2,
                       "carry": 0.5 * res2}

        def back_substitute(ctx, data, lin, dxp, aux):
            """``dxl = Dinv (bl − Bᵀ dxp)`` joined with ``dxp`` into the
            full update; a ``dm`` batch stays in bucket order until one
            placement into natural order."""
            bl = ctx["bl"]
            wl = {t: torch.zeros_like(bl[t])
                  for t in lm_types if t not in ctx["dm_lm"]}
            dxl = {}
            for name, ps, ls in obs_specs:
                pt, lt = pt_of[name], lm_of[name]
                if ctx["dm"][name]:
                    u_t = onehot_gather_t(cam_of(data, name, ps), dxp[pt])
                    t_ = bucket_down_t(bspec[name], ctx["Bt_s"][name], u_t)
                    dxl_t = torch.einsum("ijn,jn->in", ctx["Dinv_t"][name],
                                         ctx["bl_bt"][name] - t_)
                    d = p.vertex_types[lt].tangent_dim
                    dxl[lt] = seg_set(data, name, torch.zeros(
                        (p.counts[lt], d), dtype=dtype, device=dev), dxl_t.T)
                elif bucketed:
                    u = onehot_gather(cam_of(data, name, ps), dxp[pt])
                    wl[lt] = seg_add(data, name, wl[lt], bucket_down(
                        bspec[name], ctx["Bp"][name], u))
                else:
                    vidx = data.edges[name].vidx
                    wl[lt] = wl[lt].index_add(0, vidx[:, ls], torch.einsum(
                        "edl,ed->el", ctx["B"][name], dxp[pt][vidx[:, ps]]))
            for t in lm_types:
                if t not in ctx["dm_lm"]:
                    dxl[t] = torch.einsum("nij,nj->ni", ctx["Dinv"][t],
                                          bl[t] - wl[t])
            return p.join_tangent({**dxp, **dxl})

        def solve_full(data, lin, lam, aux=(), carry=None):
            """One solve: ``(dx, stats)`` with the CG iteration count and
            the final residual (the reference's iterationsLinearSolver
            statistic, ``g2o/core/batch_stats.h:59``)."""
            ctx = landmark_system(data, lin, lam, aux)
            bschur = reduced_rhs(ctx, data, lin, aux)
            diag_blocks, minv = preconditioner(ctx, data, lin, lam, aux)
            dxp, stats = cg(ctx, data, lin, bschur, diag_blocks, minv, aux,
                            carry)
            return back_substitute(ctx, data, lin, dxp, aux), stats

        self._solve_full = solve_full
        # each stage alone, for per-layer timing
        self._parts = dict(landmark_system=landmark_system,
                           reduced_rhs=reduced_rhs,
                           preconditioner=preconditioner, cg=cg,
                           back_substitute=back_substitute)
        self._layout = dict(
            bucketed=bucketed,
            form=("rows" if not bucketed else
                  "dm" if all(pre.values()) else "runtime_bucketed"),
            buckets={name: len(s[0]) for name, s in bspec.items()},
            slab_rows={name: s[2] for name, s in bspec.items()})
        self.state0 = (torch.tensor(-1.0, dtype=dtype, device=dev)
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
