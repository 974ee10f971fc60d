"""Supernodal multifrontal block-sparse Cholesky — port of
``g2o_tpu/core/solvers/supernodal.py``, the CHOLMOD-class direct solver
(``g2o/solvers/cholmod``, ``linear_solver_cholmod.h:76``).

* **host symbolic phase** (numpy, once per graph pattern): fill-reducing
  ordering + elimination tree + exact column structure
  (:func:`~g2o_tpu_torch.core.solvers.sparse_chol.symbolic_factorization`,
  the JAX package's native ``symchol.cpp``); fundamental supernodes;
  CHOLMOD-style relaxed amalgamation; quotient-etree rowset closure; level
  schedule bucketed by padded panel shape; flat frontal-slot layout,
  per-edge assembly ids and child→parent extend-add maps.  This code is
  kept line for line with the JAX package's, so both build the same
  schedule.
* **numeric phase** (device tensors, once per λ-trial): H blocks are
  added once per edge type into one flat ``(T, d, d)`` frontal-slot array;
  each level's groups are static slices of it, reshaped into dense
  frontals.  Per group: mirror the diagonal region, add λ, batched
  Cholesky of the ``(S, sp·d, sp·d)`` diagonal panels, one batched forward
  solve for the below-panel block, the update matrix ``P Pᵀ``, and its
  **extend-add** into the parent's frontal.  The JAX package wrote the
  extend-add as one-hot matmuls ``E·U·Eᵀ`` (a TPU device); here it is one
  ``index_add_`` of ``U``'s blocks at host-precomputed parent slots.
* **frontal-form solve**: forward and backward sweeps over the per-group
  ``(L_D, P)`` factors; only the ``(n, d)`` right-hand side is gathered and
  scattered by block row.

Past 96 columns (multiple of ``d``) the batched Cholesky, forward and
backward substitutions are the Hopper kernels K1, K2 and K3 of
:mod:`g2o_tpu_torch.ops.chol_kernels`; below it they are ``torch.linalg``,
where the JAX package used XLA.  Out-of-range ids, which the JAX package
drops with ``mode="drop"`` scatters, land in one spare row that is never
read.

The LM damping contract (``g2o/core/solver.h:80-93``): the numeric phase
re-runs with ``lam`` on the diagonal; the symbolic phase is reused.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from g2o_tpu_torch.core.problem import edge_sum_, full_rows, row_window
from g2o_tpu_torch.core.solvers.sparse_chol import symbolic_factorization
from g2o_tpu_torch.ops import chol_kernels


# --------------------------------------------------------------------- #
# host symbolic machinery
# --------------------------------------------------------------------- #

def supernode_partition(sym, *, smax: int = 24, zeta: float = 0.35):
    """Partition the (permuted) columns into supernodes.

    1. fundamental supernodes: maximal chains where column j extends the
       dense diagonal of j-1 (``parent[j-1] == j`` and
       ``struct(j) == struct(j-1) \\ {j}``);
    2. relaxed amalgamation: merge supernode s into the NEXT supernode p
       when p is its quotient-etree parent (``parent[last(s)] == first(p)``),
       the merged width stays <= ``smax`` and the fraction of explicit
       zeros introduced stays <= ``zeta`` (CHOLMOD's relaxation rule).

    Returns ``(starts, rowsets)`` — supernode k spans permuted columns
    ``[starts[k], starts[k+1])`` and has below-panel block rows
    ``rowsets[k]`` (sorted np.int64, all > last member column; closure
    under the quotient etree is applied by the caller)."""
    n = len(sym["rows"])
    if n == 0:
        return np.zeros(1, dtype=np.int64), []
    parent = sym["parent"]
    rows = sym["rows"]

    # --- fundamental partition ---
    starts = [0]
    for j in range(1, n):
        prev = rows[j - 1]
        fund = (parent[j - 1] == j
                and len(rows[j]) == len(prev) - 1
                and (j - starts[-1]) < smax
                and np.array_equal(rows[j], prev[prev != j]))
        if not fund:
            starts.append(j)
    starts.append(n)
    starts = np.asarray(starts, dtype=np.int64)

    # member rowsets (union of original structs minus members)
    def sn_rows(c0, c1):
        u = np.unique(np.concatenate([rows[j] for j in range(c0, c1)])) \
            if c1 > c0 else np.empty(0, dtype=np.int64)
        return u[u >= c1].astype(np.int64)

    sN = len(starts) - 1
    c0s = starts[:-1]
    c1s = starts[1:]
    rsets = [sn_rows(int(a), int(b)) for a, b in zip(c0s, c1s)]

    # --- relaxed amalgamation (greedy, left to right) ---
    # merge supernode k into k+1 when k+1 is the etree parent and the
    # padding cost is acceptable
    out_starts = [0]
    out_rows = []
    k = 0
    cur0, cur1 = int(c0s[0]), int(c1s[0])
    curR = rsets[0]
    while k + 1 < sN:
        n0, n1 = int(c0s[k + 1]), int(c1s[k + 1])
        nR = rsets[k + 1]
        is_parent = (len(curR) > 0 and n0 <= int(curR[0]) < n1)
        if is_parent:
            s_a, s_b = cur1 - cur0, n1 - n0
            m_a, m_b = len(curR), len(nR)
            mergedR = np.union1d(curR[curR >= n1], nR)
            s_m = s_a + s_b
            m_m = len(mergedR)
            nnz_before = (s_a * (s_a + 1) // 2 + s_a * m_a
                          + s_b * (s_b + 1) // 2 + s_b * m_b)
            nnz_after = s_m * (s_m + 1) // 2 + s_m * m_m
            ok_fill = (nnz_after - nnz_before) <= zeta * nnz_after
            if s_m <= smax and ok_fill:
                cur1 = n1
                curR = mergedR
                k += 1
                continue
        out_starts.append(cur1)
        out_rows.append(curR)
        cur0, cur1, curR = n0, n1, nR
        k += 1
    out_starts.append(cur1)
    out_rows.append(curR)
    return np.asarray(out_starts, dtype=np.int64), out_rows


def propagate_rowsets(starts: np.ndarray, rowsets: list):
    """Quotient-etree fill propagation: R(S) flows into the parent
    supernode P = supernode(min R(S)) as ``R(S) \\ cols(P)`` — after this
    the pattern is closed under the supernodal update rule (every pair of
    rows of a panel maps into the parent's frontal index set — the
    multifrontal extend-add invariant)."""
    sN = len(rowsets)
    if sN == 0:
        return rowsets, np.full(0, -1, dtype=np.int64)
    n = int(starts[-1])
    sn_of_col = np.empty(n, dtype=np.int64)
    for k in range(sN):
        sn_of_col[starts[k]:starts[k + 1]] = k
    parent_sn = np.full(sN, -1, dtype=np.int64)
    rowsets = [r.copy() for r in rowsets]
    for k in range(sN):
        R = rowsets[k]
        if len(R) == 0:
            continue
        p = int(sn_of_col[int(R[0])])
        parent_sn[k] = p
        passup = R[R >= int(starts[p + 1])]
        if len(passup):
            rowsets[p] = np.union1d(rowsets[p], passup)
    return rowsets, parent_sn


def _bucket(x: int, buckets):
    for b in buckets:
        if x <= b:
            return b
    return buckets[-1]


def build_supernodal_schedule(sym, *, d: int, smax: int = 24,
                              zeta: float = 0.35, device="cpu",
                              dtype=torch.float64):
    """Full symbolic pipeline: partition, closure, level/bucket schedule,
    flat frontal-slot layout, extend-add maps.

    Returns ``(aux_sched, static, meta)``:

    * ``aux_sched`` — device index tensors: ``levels`` (list per level of
      list per group of ``cols``, the (S, spb) block column ids, -1
      padded; the flat column and row ids ``cids``/``rids`` with padding
      sent to the spare row ``n``; the scalar masks ``cm``/``rm``) and
      ``pairs`` (list of ``{cidx, dst}``: the child positions, and the flat
      parent-frontal block slot of every (row, col) block of each child's
      update matrix, padding sent to the spare slot past the parent's
      frontals — the JAX package's ``pidx``/``rel`` folded into one map).
    * ``static`` — host-side schedule skeleton: per-group shapes/offsets,
      level grouping, pair group ids, flat-slot total, and the
      ``flat_slot`` lookup used to map H blocks to frontal slots.
    * ``meta`` — facts for introspection/tests (n, nnz, level count …).
    """
    n = len(sym["rows"])
    starts, rowsets = supernode_partition(sym, smax=smax, zeta=zeta)
    rowsets, parent_sn = propagate_rowsets(starts, rowsets)
    sN = len(rowsets)
    sp = (starts[1:] - starts[:-1]).astype(np.int64)
    mp = np.asarray([len(r) for r in rowsets], dtype=np.int64)

    sn_of_col = np.empty(n, dtype=np.int64)
    for k in range(sN):
        sn_of_col[starts[k]:starts[k + 1]] = k

    # supernode depths over the quotient etree
    depth = np.zeros(sN, dtype=np.int64)
    for k in range(sN):
        p = parent_sn[k]
        if p >= 0:
            depth[p] = max(depth[p], depth[k] + 1)
    L = int(depth.max()) + 1 if sN else 0

    # (level, sp-bucket, mp-bucket) groups
    s_buckets = sorted({_bucket(int(x), [1, 2, 4, 8, 16, smax])
                        for x in sp}) if sN else []
    m_buckets = [0, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096, 1 << 20]
    groups: list[dict] = []
    levels_gi: list[list[int]] = []
    group_of = np.empty((sN, 2), dtype=np.int64)      # (gi, pos)
    for li in range(L):
        sns = np.nonzero(depth == li)[0]
        buckets: dict = {}
        for k in sns:
            key = (_bucket(int(sp[k]), s_buckets),
                   _bucket(int(mp[k]), m_buckets))
            buckets.setdefault(key, []).append(int(k))
        gis = []
        for (spb, mpb), ks in sorted(buckets.items()):
            gi = len(groups)
            for pos, k in enumerate(ks):
                group_of[k] = (gi, pos)
            groups.append(dict(level=li, spb=spb, mpb=mpb, S=len(ks),
                               ks=ks))
            gis.append(gi)
        levels_gi.append(gis)

    # flat frontal-slot offsets (block units): group slab is
    # (S, fp, fp) with fp = spb + mpb; slot (pos, fa, fb) lives at
    # off + (pos*fp + fa)*fp + fb
    acc_T = 0
    for g in groups:
        g["off"] = acc_T
        fp = g["spb"] + g["mpb"]
        acc_T += g["S"] * fp * fp

    # frontal-position lookup: key k*n + r -> fpos (cols first, R at the
    # PADDED offset spb so static region slicing works)
    keys = []
    fposs = []
    for k in range(sN):
        gi = int(group_of[k, 0])
        spb = groups[gi]["spb"]
        c0, c1 = int(starts[k]), int(starts[k + 1])
        cs = np.arange(c0, c1, dtype=np.int64)
        keys.append(k * n + cs)
        fposs.append(cs - c0)
        if mp[k]:
            keys.append(k * n + rowsets[k])
            fposs.append(spb + np.arange(mp[k], dtype=np.int64))
    keys = np.concatenate(keys) if keys else np.empty(0, np.int64)
    fposs = np.concatenate(fposs) if fposs else np.empty(0, np.int64)
    order = np.argsort(keys)
    keys = keys[order]
    fposs = fposs[order]

    g_off = np.asarray([g["off"] for g in groups], dtype=np.int64)
    g_fp = np.asarray([g["spb"] + g["mpb"] for g in groups], dtype=np.int64)
    g_pos = group_of[:, 1]
    g_gi = group_of[:, 0]

    def flat_slot(i, j):
        """Flat frontal-slot ids for lower H blocks (row i >= col j, both
        permuted block indices; vectorized)."""
        i = np.asarray(i, dtype=np.int64)
        j = np.asarray(j, dtype=np.int64)
        k = sn_of_col[j]
        fa = fposs[np.searchsorted(keys, k * n + i)]
        fb = j - starts[k]
        gi = g_gi[k]
        fp = g_fp[gi]
        return g_off[gi] + (g_pos[k] * fp + fa) * fp + fb

    def ten(x, dt=torch.int64):
        return torch.as_tensor(x, dtype=dt, device=device)

    # extend-add maps, grouped by (child group, parent group)
    pair_map: dict = {}
    for k in range(sN):
        p = int(parent_sn[k])
        if p < 0 or mp[k] == 0:
            continue
        cg, cpos = int(group_of[k, 0]), int(group_of[k, 1])
        pg, ppos = int(group_of[p, 0]), int(group_of[p, 1])
        R = rowsets[k]
        spb_p = groups[pg]["spb"]
        c1p = int(starts[p + 1])
        rel = np.where(
            R < c1p, R - int(starts[p]),
            spb_p + np.searchsorted(rowsets[p], R))
        mp_cb = groups[cg]["mpb"]
        rel_pad = np.full(mp_cb, -1, dtype=np.int64)
        rel_pad[:len(R)] = rel
        pair_map.setdefault((cg, pg), []).append((cpos, ppos, rel_pad))

    pairs_static = []
    pairs_aux = []
    for (cg, pg), entries in sorted(pair_map.items()):
        cidx = np.asarray([e[0] for e in entries], dtype=np.int64)
        pidx = np.asarray([e[1] for e in entries], dtype=np.int64)
        rel = np.stack([e[2] for e in entries])
        gp = groups[pg]
        fpp = gp["spb"] + gp["mpb"]
        # block (x, y) of child s's update matrix lands in parent frontal
        # pidx[s] at (rel[s, x], rel[s, y]); padding goes to the spare slot
        ok = (rel[:, :, None] >= 0) & (rel[:, None, :] >= 0)
        dst = np.where(ok, (pidx[:, None, None] * fpp + rel[:, :, None])
                       * fpp + rel[:, None, :], gp["S"] * fpp * fpp)
        pairs_static.append(dict(cg=cg, pg=pg))
        pairs_aux.append(dict(cidx=ten(cidx), dst=ten(dst.reshape(-1))))

    # per-group cols/rows arrays, nested per level (the structure the
    # solve sweeps walk; also reused as factor-time masks)
    levels_aux = []
    for gis in levels_gi:
        lv = []
        for gi in gis:
            g = groups[gi]
            S, spb, mpb = g["S"], g["spb"], g["mpb"]
            cols_g = np.full((S, spb), -1, dtype=np.int64)
            rows_g = np.full((S, mpb), -1, dtype=np.int64)
            for pos, k in enumerate(g["ks"]):
                c0, c1 = int(starts[k]), int(starts[k + 1])
                cols_g[pos, :c1 - c0] = np.arange(c0, c1)
                if mp[k]:
                    rows_g[pos, :mp[k]] = rowsets[k]
            lv.append(dict(
                cols=ten(cols_g),
                cids=ten(np.where(cols_g >= 0, cols_g, n).reshape(-1)),
                rids=ten(np.where(rows_g >= 0, rows_g, n).reshape(-1)),
                cm=ten(np.repeat(cols_g >= 0, d, axis=1), dtype),
                rm=ten(np.repeat(rows_g >= 0, d, axis=1), dtype)))
        levels_aux.append(lv)

    nnz = int(sum(int(sp[k]) * (int(sp[k]) - 1) // 2
                  + int(sp[k]) * int(mp[k]) for k in range(sN)))
    static = dict(groups=groups, levels=levels_gi, pairs=pairs_static,
                  acc_T=acc_T, flat_slot=flat_slot, n=n)
    meta = dict(n=n, d=d, nnz=nnz, n_levels=L, n_supernodes=sN,
                starts=starts, rowsets=rowsets)
    return dict(levels=levels_aux, pairs=pairs_aux), static, meta


# --------------------------------------------------------------------- #
# batched dense factor/solve dispatch
# --------------------------------------------------------------------- #

# Up to 96 columns (the JAX package's ``_SAFE_XLA_DIM``: there XLA did the
# work outside Pallas) a batch goes to ``torch.linalg``.  Past 96 columns,
# when the size is a multiple of the block width ``d``, it goes to the
# Hopper kernels K1/K2/K3 — the launch on a CUDA tensor, their plain
# version on a CPU tensor.  The TPU's d-blocked emulation and its VMEM
# guard have no counterpart here: the kernels take any size.
_SAFE_XLA_DIM = 96


def _chol_batched(D, d: int):
    """Batched lower Cholesky of ``(S, sd, sd)``.  A matrix that is not
    positive definite gets a NaN factor on either route, as XLA's Cholesky
    gives it (the LM trial then fails on a non-finite chi2)."""
    sd = D.shape[-1]
    if sd <= _SAFE_XLA_DIM or sd % d:
        return chol_kernels.chol_batched_plain(D)
    return chol_kernels.chol_batched(D.contiguous())


def _solve_lower_batched(L, B, d: int):
    """Solve ``L Y = B`` with ``L (S, sd, sd)`` lower, ``B (S, sd, m)``."""
    sd = L.shape[-1]
    if sd <= _SAFE_XLA_DIM or sd % d:
        return chol_kernels.solve_lower_batched_plain(L, B)
    return chol_kernels.solve_lower_batched(L.contiguous(), B.contiguous())


def _solve_upper_batched(L, B, d: int):
    """Solve ``Lᵀ X = B`` with ``L`` lower — the backward sweep."""
    sd = L.shape[-1]
    if sd <= _SAFE_XLA_DIM or sd % d:
        return chol_kernels.solve_upper_batched_plain(L, B)
    return chol_kernels.solve_upper_batched(L.contiguous(), B.contiguous())


# --------------------------------------------------------------------- #
# device numeric phase
# --------------------------------------------------------------------- #

@functools.lru_cache(maxsize=None)
def _strict_lower_block_mask(sp: int, d: int, dtype, device):
    """(sp*d, sp*d) scalar mask of the strictly-lower BLOCK triangle."""
    m = np.kron(np.tril(np.ones((sp, sp)), -1), np.ones((d, d)))
    return torch.as_tensor(m, dtype=dtype, device=device)


def _blocks_to_dense(flat, S: int, fp: int, d: int):
    """``(S·fp·fp, d, d)`` block-slot layout -> dense ``(S, fp·d, fp·d)``."""
    return (flat.reshape(S, fp, fp, d, d).permute(0, 1, 3, 2, 4)
            .reshape(S, fp * d, fp * d))


def factorize_frontal(ACC, aux, static, d: int, lam, gfixed_p, gvalid_p):
    """Multifrontal numeric factorization.

    ``ACC``: flat (acc_T, d, d) frontal-slot array holding the assembled
    LOWER H blocks (diagonal blocks full).  ``gfixed_p``/``gvalid_p``:
    per-permuted-block fixed flags (n,) and valid-dim masks (n, d).
    Returns ``factors`` — per level, per group ``(Ld, Pm)`` dense panels
    matching ``aux['levels']``'s structure."""
    dtype, device = ACC.dtype, ACC.device
    groups = static["groups"]
    pairs_by_child: dict = {}
    for ps, pa in zip(static["pairs"], aux["pairs"]):
        pairs_by_child.setdefault(ps["cg"], []).append((ps, pa))

    # pending child updates per parent group, in block-slot layout with one
    # spare slot at the end for the padded update blocks
    pending: dict = {}
    factors = []
    for li, gis in enumerate(static["levels"]):
        lv_f = []
        for gj, gi in enumerate(gis):
            g = groups[gi]
            ga = aux["levels"][li][gj]
            S, spb, mpb = g["S"], g["spb"], g["mpb"]
            fp = spb + mpb
            spd = spb * d
            # static slice of the flat assembly array -> dense frontals
            slab = _blocks_to_dense(ACC[g["off"]:g["off"] + S * fp * fp],
                                    S, fp, d)
            pend = pending.pop(gi, None)
            if pend is not None:
                pend = _blocks_to_dense(pend[:-1], S, fp, d)

            # diagonal region: mirror H's strict-lower block triangle
            # (assembly wrote lower only), then add the FULL-symmetric
            # pending child updates
            D = slab[:, :spd, :spd]
            low = _strict_lower_block_mask(spb, d, dtype, device)
            D = D + (D * low).mT
            if pend is not None:
                D = D + pend[:, :spd, :spd]
            # λ on valid non-fixed tangent dims; unit diagonal on fixed
            # rows, padding dims and padded columns (H is zero there —
            # fixed slots are masked at linearize)
            cols = ga["cols"]
            safe = cols.clamp(min=0)
            colmask = cols >= 0
            fx = gfixed_p[safe] & colmask                  # (S, spb)
            vm = gvalid_p[safe] * colmask[..., None].to(dtype)
            dadd = torch.where(fx[..., None], 1.0, lam * vm + (1.0 - vm))
            D = D + torch.diag_embed(dadd.reshape(S, spd))
            Ld = torch.tril(_chol_batched(D, d))

            if mpb == 0:
                lv_f.append((Ld, Ld.new_zeros((S, 0, spd))))
                continue

            P = slab[:, spd:, :spd]
            if pend is not None:
                P = P + pend[:, spd:, :spd]
            Pt = _solve_lower_batched(Ld, P.mT, d)
            Pm = Pt.mT * ga["cm"][:, None, :] * ga["rm"][:, :, None]
            lv_f.append((Ld, Pm))

            # update matrix: panel outer product + inherited (R×R) part
            # (H never lands there — those blocks belong to ancestors)
            U = Pm @ Pm.mT
            if pend is not None:
                U = U - pend[:, spd:, spd:]

            # extend-add into parents: every (d, d) block of each child's
            # U added at its parent-frontal slot (sums over siblings)
            for ps, pa in pairs_by_child.get(gi, ()):
                pg = ps["pg"]
                gp = groups[pg]
                fpp = gp["spb"] + gp["mpb"]
                Usub = U[pa["cidx"]]                  # (Sc, mpd, mpd)
                Sc = Usub.shape[0]
                Ub = (Usub.reshape(Sc, mpb, d, mpb, d).permute(0, 1, 3, 2, 4)
                      .reshape(-1, d, d))
                acc = pending.get(pg)
                if acc is None:
                    acc = torch.zeros((gp["S"] * fpp * fpp + 1, d, d),
                                      dtype=dtype, device=device)
                    pending[pg] = acc
                acc.index_add_(0, pa["dst"], Ub, alpha=-1)
        factors.append(lv_f)
    return factors


def solve_supernodal(factors, b, levels, d: int):
    """L L^T x = b with the frontal-form factor.  ``factors``: nested
    per-level/per-group ``(Ld, Pm)`` (the output of
    :func:`factorize_frontal`); ``levels``: matching nested index tensors
    (``aux['levels']``); ``b``: (n, d) permuted block rhs, or (n, d, m)
    for m right-hand sides at once; not modified."""
    one = b.dim() == 2
    if one:
        b = b[..., None]
    n, m = b.shape[0], b.shape[2]
    # row n is the target of the padded ids; only zeros land there
    b = torch.cat([b, b.new_zeros((1, d, m))])

    def gather_rhs(ids, mask):              # block ids -> (S, P*d, m)
        return b[ids].reshape(mask.shape + (m,)) * mask[..., None]

    # forward: per level ascending — y_S = L_SS^{-1} b_S; b_R -= P y_S
    for lv_f, lv_a in zip(factors, levels):
        for (Ld, Pm), ga in zip(lv_f, lv_a):
            rhs = gather_rhs(ga["cids"], ga["cm"])
            y = _solve_lower_batched(Ld, rhs, d) * ga["cm"][..., None]
            b.index_copy_(0, ga["cids"], y.reshape(-1, d, m))
            if Pm.shape[1]:
                b.index_add_(0, ga["rids"], (Pm @ y).reshape(-1, d, m),
                             alpha=-1)

    # backward: per level descending — x_S = L_SS^{-T}(y_S - P^T x_R)
    for lv_f, lv_a in zip(reversed(factors), reversed(levels)):
        for (Ld, Pm), ga in zip(lv_f, lv_a):
            rhs = gather_rhs(ga["cids"], ga["cm"])
            if Pm.shape[1]:
                rhs = rhs - Pm.mT @ gather_rhs(ga["rids"], ga["rm"])
            x = _solve_upper_batched(Ld, rhs, d) * ga["cm"][..., None]
            b.index_copy_(0, ga["cids"], x.reshape(-1, d, m))
    return b[:n, :, 0] if one else b[:n]


# --------------------------------------------------------------------- #
# solver class
# --------------------------------------------------------------------- #

class SupernodalCholeskySolver:
    """Direct supernodal multifrontal block-Cholesky solver — the
    CHOLMOD-class direct solver.  Symbolic analysis + amalgamation run
    once at setup; each ``solve`` re-runs the batched dense numeric phase
    with the current lambda.  Mixed vertex types ride global block ids
    with top-left padding to the max tangent dim (CHOLMOD covers this with
    variable block sizes, ``linear_solver_cholmod.h:76``); n-ary edges
    contribute one H block per slot pair (``block_solver.hpp:142-214``)."""

    name = "supernodal"

    def __init__(self, *, smax: int = 24, zeta: float = 0.35,
                 min_separator_size: int = 32, refine: int = 1):
        self.smax = int(smax)
        self.zeta = float(zeta)
        self.min_size = int(min_separator_size)
        # iterative-refinement sweeps: in f32 the factorization of an
        # ill-conditioned pose-graph Hessian carries a ~1e-2 relative solve
        # error; each sweep reuses the factor plus one matrix-free H·v to
        # shrink it (residual cost << factorization cost)
        self.refine = int(refine)
        self.aux = ()
        self._solve_fn = None
        self._setup_for = None

    def setup(self, problem, force: bool = False):
        """Symbolic analysis and index maps for ``problem`` (a no-op when
        called again for the same problem)."""
        if self._setup_for is problem and not force:
            return self
        self._setup_for = None
        p = problem
        dev, dtype = p.device, p.dtype
        tnames = list(p.vertex_types)
        dims = {t: p.vertex_types[t].tangent_dim for t in tnames}
        d = max(dims.values())               # padded uniform block dim
        base = {}
        acc = 0
        for t in tnames:
            base[t] = acc
            acc += p.counts[t]
        n = acc
        # every edge row (gathered when this process holds a slice): the
        # pattern and the assembly maps are the whole graph's; a solve on
        # sharded data reads its rows' part of each map and completes the
        # assembled blocks with one all-reduce
        vidx_np = {name: full_rows(p.data, p.data.edges[name].vidx)
                   .cpu().numpy() for name in p.edge_types}

        # block pattern: ALL vertex pairs of every edge (n-ary included) on
        # global block ids across types — mixed types ride the uniform
        # batched schedule via top-left padding
        pair_set = set()
        slot_pairs = {name: [(a, b)
                             for a in range(et.num_slots)
                             for b in range(a + 1, et.num_slots)]
                      for name, et in p.edge_types.items()}
        for name, et in p.edge_types.items():
            vidx = vidx_np[name]
            for a, b in slot_pairs[name]:
                ga = base[et.vertex_types[a].name] + vidx[:, a]
                gb = base[et.vertex_types[b].name] + vidx[:, b]
                lo = np.minimum(ga, gb)
                hi = np.maximum(ga, gb)
                m = lo != hi
                pair_set.update(zip(lo[m].tolist(), hi[m].tolist()))
        pairs = np.asarray(sorted(pair_set), dtype=np.int64).reshape(-1, 2)

        sym = symbolic_factorization(n, pairs, min_size=self.min_size)
        aux_sched, static, meta = build_supernodal_schedule(
            sym, d=d, smax=self.smax, zeta=self.zeta, device=dev,
            dtype=dtype)
        self.meta = meta
        self._static = static
        inv = sym["inv"].astype(np.int64)
        acc_T = static["acc_T"]
        flat_slot = static["flat_slot"]

        def ten(x, dt=torch.int64):
            return torch.as_tensor(x, dtype=dt, device=dev)

        # per-(edge type, slot) diagonal assembly ids and per-(edge type,
        # slot pair) off-diagonal assembly ids into the flat frontal-slot
        # array (ONE index_add_ per edge array — the reference assembles
        # into CHOLMOD's column-major slots the same once-per-block way,
        # ``block_solver.hpp:142-214``); id acc_T is the spare slot
        asm_diag = {}
        asm_off = {}
        asm_self = {}
        for name, et in p.edge_types.items():
            vidx = vidx_np[name]
            for s in range(et.num_slots):
                gi = base[et.vertex_types[s].name] + vidx[:, s]
                i = inv[gi]
                asm_diag[(name, s)] = ten(flat_slot(i, i))
            for a, b in slot_pairs[name]:
                ga = base[et.vertex_types[a].name] + vidx[:, a]
                gb = base[et.vertex_types[b].name] + vidx[:, b]
                i = inv[ga]
                j = inv[gb]
                valid = ga != gb
                lo = np.where(valid, np.minimum(i, j), 0)
                hi = np.where(valid, np.maximum(i, j), 1)
                slots = np.where(valid, flat_slot(hi, lo), acc_T)
                transpose = i < j
                asm_off[(name, a, b)] = (ten(slots),
                                         ten(transpose, torch.bool))
                # both slots bind the SAME vertex: H_ab + H_abᵀ belongs to
                # its DIAGONAL frontal slot (rare; extra index_add_ only
                # when present)
                if (~valid).any():
                    asm_self[(name, a, b)] = ten(
                        np.where(valid, acc_T, flat_slot(i, i)))

        # global fixed mask + per-slot validity, PERMUTED block order
        fixed_np = np.zeros(n, dtype=bool)
        valid_np = np.zeros((n, d), dtype=np.float64)
        for t in tnames:
            fixed_np[base[t]:base[t] + p.counts[t]] = \
                p.data.fixed[t].cpu().numpy()
            valid_np[base[t]:base[t] + p.counts[t], :dims[t]] = 1.0
        perm = np.asarray(sym["perm"], dtype=np.int64)
        self.aux = dict(levels=aux_sched["levels"],
                        pairs=aux_sched["pairs"],
                        perm=ten(perm), inv=ten(inv),
                        asm_diag=asm_diag, asm_off=asm_off,
                        asm_self=asm_self,
                        gfixed=ten(fixed_np[perm], torch.bool),
                        gvalid=ten(valid_np[perm], dtype))

        def _pad_block(M):
            a, b = M.shape[-2], M.shape[-1]
            if a == d and b == d:
                return M
            return torch.nn.functional.pad(M, (0, d - b, 0, d - a))

        def assemble_and_factor(data, lin, lam, aux):
            # TF32 is off package-wide: every product below is full
            # precision (TF32 rounding can make the trailing frontals of
            # an ill-conditioned pose-graph Hessian indefinite)
            ACC = torch.zeros((acc_T + 1, d, d), dtype=dtype, device=dev)
            for name, et in p.edge_types.items():
                Js = p.edge_jacs(lin, name)
                W = p.edge_weights(lin, name)
                lo, nr = row_window(data, name)
                for s in range(et.num_slots):
                    Hss = torch.einsum("erd,ers,esf->edf", Js[s], W, Js[s])
                    ACC.index_add_(0, aux["asm_diag"][(name, s)][lo:lo + nr],
                                   _pad_block(Hss))
                for a, b in slot_pairs[name]:
                    Hab = _pad_block(torch.einsum("erd,ers,esf->edf", Js[a],
                                                  W, Js[b]))
                    slots, transpose = aux["asm_off"][(name, a, b)]
                    HabT = Hab.mT
                    ACC.index_add_(0, slots[lo:lo + nr], torch.where(
                        transpose[lo:lo + nr, None, None], HabT, Hab))
                    sids = aux["asm_self"].get((name, a, b))
                    if sids is not None:
                        # same-vertex slot pair -> diagonal frontal slot
                        ACC.index_add_(0, sids[lo:lo + nr], Hab + HabT)
            edge_sum_(data, ACC)
            return factorize_frontal(ACC, aux, static, d, lam,
                                     aux["gfixed"], aux["gvalid"])

        def to_full(blocks):
            """``{type: (N_t, d_t)}`` -> ``(n, d)`` zero-padded."""
            full = torch.zeros((n, d), dtype=dtype, device=dev)
            for t in tnames:
                full[base[t]:base[t] + p.counts[t], :dims[t]] = blocks[t]
            return full

        def to_blocks(x):
            return {t: x[base[t]:base[t] + p.counts[t], :dims[t]]
                    for t in tnames}

        def sweep(factors, v, aux):
            """One forward + backward solve of the natural-order ``(n, d)``
            right-hand side ``v`` with the factor."""
            return solve_supernodal(factors, v[aux["perm"]], aux["levels"],
                                    d)[aux["inv"]]

        def residual(data, lam, bfull, x, hvp):
            """``b − (H + λI)x`` in ``(n, d)`` layout, identity rows on fixed
            vertices (padding slots: unit diagonal, b = 0, x = 0 -> 0)."""
            xb = to_blocks(x)
            hv = hvp(xb)
            Ax = {}
            for t in tnames:
                fxt = data.fixed[t].to(dtype)[:, None]
                Ax[t] = hv[t] + lam * xb[t] * (1.0 - fxt) + xb[t] * fxt
            return bfull - to_full(Ax)

        n_refine = self.refine

        def solve(data, lin, lam, aux):
            factors = assemble_and_factor(data, lin, lam, aux)
            bfull = to_full(p.split_tangent(lin.b))
            x = sweep(factors, bfull, aux)
            if n_refine:
                hvp = p.hvp_operator(data, lin, precision="highest")
                for _ in range(n_refine):
                    x = x + sweep(factors,
                                  residual(data, lam, bfull, x, hvp), aux)
            return p.join_tangent(to_blocks(x))

        self._factor_fn = assemble_and_factor
        self._solve_fn = solve
        # the parts of one solve, for timing each alone
        self._parts = dict(to_full=to_full, sweep=sweep, residual=residual)
        self._setup_for = problem
        return self

    def solve(self, data, lin, lam=0.0):
        return self._solve_fn(data, lin, lam, self.aux)
