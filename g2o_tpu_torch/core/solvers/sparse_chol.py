"""Block-sparse Cholesky solver — port of
``g2o_tpu/core/solvers/sparse_chol.py``, the analogue of the reference's
CSparse/CHOLMOD direct solvers (``g2o/solvers/csparse``,
``solvers/cholmod``).

* **host symbolic phase** (once per graph pattern, the analogue of the
  reference's symbolic AMD analysis reused across iterations,
  ``linear_solver_csparse.h:71``): the fill-reducing ordering (recursive
  BFS-separator nested dissection), the elimination tree and the exact
  block structure of L.  The native path runs the JAX package's own
  ``symchol.cpp`` (:mod:`g2o_tpu_torch.native`), so both packages order
  every graph the same way; without a compiler the pure-Python path below
  runs instead.  :mod:`g2o_tpu_torch.core.solvers.supernodal` consumes it
  too;
* **level schedule** (:func:`build_schedule`): columns grouped by
  elimination-tree height, with per level the column solves and the
  right-looking update triples ``(src_a, src_b, dst)``.  The JAX package
  pads the levels to one shape for its ``fori_loop``; here the padding is
  trimmed on the host at setup (:func:`trim_levels`) and the numeric
  phase is a Python loop over levels;
* **numeric phase** (:func:`factorize`, :func:`solve_factored`): per level
  a batched ``cholesky_ex`` of the diagonal blocks (a block that is not
  positive definite becomes NaN on the device, as the JAX package's
  Cholesky gives it, so an LM trial fails instead of raising), a batched
  ``solve_triangular`` of the column blocks, and the outer-product updates
  by ``index_add_``.  The JAX package computes these outside any Pallas
  kernel, as library calls;
* **selected inverse** (:func:`build_takahashi_schedule`,
  :func:`selected_inverse`): the block Takahashi recursion on the factor
  pattern, one reverse level sweep, for the marginals.

The reference's LM damping contract (``solver.h:80-93``) maps to
re-running the numeric phase with ``λ`` added to the diagonal blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from g2o_tpu_torch.core.problem import edge_sum_, full_rows, row_window
from g2o_tpu_torch.ops.smallblocks import cholesky_or_nan


def _nested_dissection(adj: list, nodes: np.ndarray, min_size: int = 32):
    """Recursive BFS-layer separator ordering; returns node order (list).
    Children first, separator last — ancestors of both halves."""
    n = len(nodes)
    if n <= min_size:
        return list(nodes)
    nodeset = set(int(x) for x in nodes)
    # BFS from an eccentric node
    start = int(nodes[0])
    for _ in range(2):
        layers = _bfs_layers(adj, start, nodeset)
        start = layers[-1][-1]
    layers = _bfs_layers(adj, start, nodeset)
    if len(layers) < 3:
        return list(nodes)
    # separator = middle layer
    mid = len(layers) // 2
    sep = set(layers[mid])
    part_a = [v for layer in layers[:mid] for v in layer]
    part_b = [v for layer in layers[mid + 1:] for v in layer]
    covered = sep | set(part_a) | set(part_b)
    # disconnected leftovers go to part_a
    part_a += [v for v in nodeset if v not in covered]
    order = []
    if part_a:
        order += _nested_dissection(adj, np.asarray(part_a), min_size)
    if part_b:
        order += _nested_dissection(adj, np.asarray(part_b), min_size)
    order += sorted(sep)
    return order


def _bfs_layers(adj, start, nodeset):
    seen = {start}
    layers = [[start]]
    while True:
        nxt = []
        for v in layers[-1]:
            for w in adj[v]:
                if w in nodeset and w not in seen:
                    seen.add(w)
                    nxt.append(w)
        if not nxt:
            break
        layers.append(nxt)
    return layers


def _fill_from_perm(n: int, pairs: np.ndarray, perm: np.ndarray):
    """Pure-Python symbolic fill for a GIVEN ordering (the classic
    struct-merge algorithm).  Returns (parent, depth, colptr, rows_flat)."""
    inv = np.empty(n, dtype=np.int32)
    inv[perm] = np.arange(n, dtype=np.int32)          # old id -> new k

    # column structures in permuted space: struct[j] starts as neighbours
    # > j; eliminate columns in order, merging struct[j] \ {min} into
    # struct[parent]
    struct = [set() for _ in range(n)]
    for a, b in pairs:
        i, j = inv[int(a)], inv[int(b)]
        if i < j:
            i, j = j, i
        struct[j].add(int(i))          # rows below the diagonal of col j
    parent = np.full(n, -1, dtype=np.int32)
    for j in range(n):
        if struct[j]:
            p = min(struct[j])
            parent[j] = p
            struct[p].update(x for x in struct[j] if x != p)

    depth = np.zeros(n, dtype=np.int32)
    for j in range(n):
        p = parent[j]
        if p >= 0:
            depth[p] = max(depth[p], depth[j] + 1)

    colptr = np.zeros(n + 1, dtype=np.int64)
    for j in range(n):
        colptr[j + 1] = colptr[j] + len(struct[j])
    rows_flat = np.empty(colptr[-1], dtype=np.int32)
    for j in range(n):
        rows_flat[colptr[j]:colptr[j + 1]] = sorted(struct[j])
    return parent, depth, colptr, rows_flat


def _symbolic_python(n: int, pairs: np.ndarray, min_size: int):
    """Pure-Python symbolic analysis (the path when the native library is
    unavailable).  Returns (perm, parent, depth, colptr, rows_flat)."""
    adj = [[] for _ in range(n)]
    for a, b in pairs:
        a, b = int(a), int(b)
        adj[a].append(b)
        adj[b].append(a)

    order = _nested_dissection(adj, np.arange(n), min_size=min_size)
    perm = np.asarray(order, dtype=np.int32)          # new k -> old id
    return (perm,) + _fill_from_perm(n, pairs, perm)


def symbolic_factorization(n: int, pairs: np.ndarray, *, min_size: int = 32):
    """Symbolic block Cholesky: fill-reducing ordering, elimination tree,
    exact L structure and etree depths, natively (``symchol.cpp``) or in
    pure Python.

    Args:
      n: number of block columns.
      pairs: (M, 2) unique undirected off-diagonal block pairs.
    Returns a dict with the permutation, the L block structure (flat
    ``colptr``/``rows_flat`` + per-column ``rows`` views) and the level
    schedule (all in PERMUTED indices)."""
    from g2o_tpu_torch import native

    res = native.symbolic_analysis(n, pairs, min_size) if n else None
    if res is not None:
        perm, parent, depth = res["perm"], res["parent"], res["depth"]
        colptr, rows_flat = res["colptr"], res["rows"]
    else:
        perm, parent, depth, colptr, rows_flat = _symbolic_python(
            n, pairs, min_size)

    inv = np.empty(n, dtype=np.int32)
    inv[perm] = np.arange(n, dtype=np.int32)          # old id -> new k

    levels: list[list[int]] = [[] for _ in range(int(depth.max()) + 1
                                                 if n else 0)]
    for j in np.argsort(depth, kind="stable"):
        levels[depth[j]].append(int(j))

    rows = [rows_flat[colptr[j]:colptr[j + 1]] for j in range(n)]
    return {
        "perm": perm, "inv": inv, "parent": parent, "rows": rows,
        "levels": levels, "nnz_blocks": int(colptr[-1]),
        "colptr": colptr, "rows_flat": rows_flat, "depth": depth,
    }


def _pad_by_level(level_of, payload, L, fill=-1):
    """Bucket ``payload`` rows (K, w) by ``level_of`` (K,) into a padded
    (L, maxK, w) array — vectorized (no per-level python loops)."""
    payload = np.asarray(payload)
    K = payload.shape[0]
    if K == 0:
        return np.full((L, 1) + payload.shape[1:], fill, dtype=np.int64)
    order = np.argsort(level_of, kind="stable")
    lv_sorted = level_of[order]
    counts = np.bincount(lv_sorted, minlength=L)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(K) - starts[lv_sorted]
    out = np.full((L, int(counts.max())) + payload.shape[1:], fill,
                  dtype=np.int64)
    out[lv_sorted, within] = payload[order]
    return out


def build_schedule(sym, d: int):
    """Flatten the symbolic data into padded per-level index arrays —
    fully vectorized (the update-triple count is O(sum |col|^2)).

    Block storage layout: slot j in [0, n) = diagonal block of column j;
    slot n + e = e-th off-diagonal block (column-major over ``rows``)."""
    n = len(sym["rows"])
    colptr = np.asarray(sym["colptr"], dtype=np.int64)
    rows_flat = np.asarray(sym["rows_flat"], dtype=np.int64)
    depth = np.asarray(sym["depth"], dtype=np.int64)
    nnz = int(colptr[-1])
    L = int(depth.max()) + 1 if n else 0
    lens = colptr[1:] - colptr[:-1]

    # slot -> row map
    col_of_off = np.repeat(np.arange(n, dtype=np.int64), lens)
    row_of_slot = np.concatenate([np.arange(n, dtype=np.int64), rows_flat])

    # globally-ascending (col, row) key of the off-diagonal slots: rows are
    # sorted per column and slots ordered by column, so searchsorted gives
    # off_slot(i, j) = n + searchsorted(key, j*(n+1)+i)
    key_all = col_of_off * (n + 1) + rows_flat

    def off_slot_v(i, j):
        return n + np.searchsorted(key_all, j * (n + 1) + i)

    # level membership of columns
    lvl_cols = _pad_by_level(depth, np.arange(n, dtype=np.int64)[:, None], L)
    lvl_cols = lvl_cols[..., 0].astype(np.int32)

    # solves: one per off-diagonal slot (slot, col), level = depth[col]
    solve_payload = np.stack(
        [n + np.arange(nnz, dtype=np.int64), col_of_off], axis=1)
    sv = _pad_by_level(depth[col_of_off], solve_payload, L)

    # update triples: per column j, all ordered pairs (a <= b) over rows(j):
    #   srcA = slot(rows[b], j), srcB = slot(rows[a], j),
    #   dst  = diag slot  when rows[a] == rows[b] (a == b),
    #          off_slot(rows[b], rows[a]) otherwise.
    # vectorized by grouping columns of equal length
    srcA_l, srcB_l, dst_l, lvl_l = [], [], [], []
    for l in np.unique(lens):
        if l == 0:
            continue
        cols_l = np.nonzero(lens == l)[0]                # (C,)
        a, b = np.triu_indices(int(l))                   # (P,)
        base = colptr[cols_l][:, None]                   # (C, 1)
        pa = base + a[None, :]
        pb = base + b[None, :]
        i = rows_flat[pb]
        k = rows_flat[pa]
        dst = np.where(i == k, k, off_slot_v(i, k))
        srcA_l.append((n + pb).ravel())
        srcB_l.append((n + pa).ravel())
        dst_l.append(dst.ravel())
        lvl_l.append(np.repeat(depth[cols_l], len(a)))
    if srcA_l:
        upd_payload = np.stack([np.concatenate(srcA_l),
                                np.concatenate(srcB_l),
                                np.concatenate(dst_l)], axis=1)
        up = _pad_by_level(np.concatenate(lvl_l), upd_payload, L)
    else:
        up = np.full((max(L, 1), 1, 3), -1, dtype=np.int64)
    if sv.shape[0] == 0:
        sv = np.full((max(L, 1), 1, 2), -1, dtype=np.int64)

    return {
        "n": n, "d": d, "nnz": nnz, "L": L,
        "lvl_cols": lvl_cols,
        "solves": sv, "updates": up,
        "row_of_slot": row_of_slot,
        "off_slot_v": off_slot_v,
    }


def trim_levels(sched, device, pairs=None):
    """The padded per-level arrays of :func:`build_schedule` (and, given
    ``pairs``, of :func:`build_takahashi_schedule`) as one dict of
    UNPADDED index tensors per level, on ``device``:

    * ``cols`` — the level's columns (ascending);
    * ``s_slot``, ``s_col``, ``s_row`` — its off-diagonal slots, their
      column and their row;
    * ``u_a``, ``u_b``, ``u_dst`` — its update triples;
    * with ``pairs``: ``t_srcS``, ``t_tr``, ``t_srcL`` (the Takahashi
      pairs), ``t_dst`` (each pair's target as a position in the level's
      off-diagonal slots) and ``t_col`` (each off-diagonal slot's column as
      a position in ``cols``)."""
    row_of_slot = sched["row_of_slot"]

    def ten(x, dt=torch.int64):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dt,
                               device=device)

    out = []
    for li in range(sched["L"]):
        cols = sched["lvl_cols"][li]
        cols = cols[cols >= 0].astype(np.int64)
        sv = sched["solves"][li]
        sv = sv[sv[:, 0] >= 0]
        up = sched["updates"][li]
        up = up[up[:, 0] >= 0]
        lv = dict(cols=ten(cols), s_slot=ten(sv[:, 0]), s_col=ten(sv[:, 1]),
                  s_row=ten(row_of_slot[sv[:, 0]]), u_a=ten(up[:, 0]),
                  u_b=ten(up[:, 1]), u_dst=ten(up[:, 2]))
        if pairs is not None:
            pr = pairs[li]
            pr = pr[pr[:, 0] >= 0]
            n = sched["n"]
            lv.update(t_srcS=ten(pr[:, 0]), t_tr=ten(pr[:, 1] == 1,
                                                     torch.bool),
                      t_srcL=ten(pr[:, 2]),
                      t_dst=ten(np.searchsorted(sv[:, 0] - n, pr[:, 3])),
                      t_col=ten(np.searchsorted(cols, sv[:, 1])))
        out.append(lv)
    return out


# --------------------------------------------------------------------- #
# numeric phase
# --------------------------------------------------------------------- #

def factorize(blocks, levels):
    """Numeric level-scheduled block Cholesky, in place.

    ``blocks``: (n + nnz, d, d) — diagonal blocks first (slots [0, n)),
    then off-diagonal blocks L-pattern-aligned (zero where no original
    entry).  Returns the factor in the same layout (L_jj lower-triangular
    in the diagonal slots, L_ij in the off-diagonal slots).  ``levels``:
    :func:`trim_levels`'s output."""
    for lv in levels:
        # 1. factor the diagonal blocks of this level's columns
        cols = lv["cols"]
        blocks[cols] = cholesky_or_nan(blocks[cols])
        # 2. column solves: L_ij = A_ij L_jj^{-T}
        s_slot = lv["s_slot"]
        if s_slot.numel():
            Xt = torch.linalg.solve_triangular(
                blocks[lv["s_col"]], blocks[s_slot].mT, upper=False)
            blocks[s_slot] = Xt.mT
        # 3. right-looking updates: dst -= L_a L_b^T
        if lv["u_dst"].numel():
            blocks.index_add_(0, lv["u_dst"],
                              blocks[lv["u_a"]] @ blocks[lv["u_b"]].mT,
                              alpha=-1)
    return blocks


def solve_factored(blocks, b, levels):
    """Triangular solves ``L Lᵀ x = b`` with the level schedule; ``b``:
    (n, d), not modified."""
    y = b.clone()
    # forward: y_j = L_jj^{-1} b_j; then b_i -= L_ij y_j for i in rows(j)
    for lv in levels:
        cols = lv["cols"]
        y[cols] = torch.linalg.solve_triangular(
            blocks[cols], y[cols][..., None], upper=False)[..., 0]
        s_slot = lv["s_slot"]
        if s_slot.numel():
            contrib = (blocks[s_slot] @ y[lv["s_col"]][..., None])[..., 0]
            y.index_add_(0, lv["s_row"], contrib, alpha=-1)
    # backward, reverse level order: y_j -= L_ijᵀ x_i (x_i final in the
    # higher levels), then x_j = L_jj^{-T} y_j
    for lv in reversed(levels):
        s_slot = lv["s_slot"]
        if s_slot.numel():
            contrib = (blocks[s_slot].mT @ y[lv["s_row"]][..., None])[..., 0]
            y.index_add_(0, lv["s_col"], contrib, alpha=-1)
        cols = lv["cols"]
        y[cols] = torch.linalg.solve_triangular(
            blocks[cols].mT, y[cols][..., None], upper=True)[..., 0]
    return y


def build_takahashi_schedule(sym):
    """Per-level pair schedule for the block Takahashi selected inverse.

    For each column ``j`` with below-diagonal structure ``S`` the
    recursion needs, per target row ``s_a`` of ``S``, the reduction
    ``W_a = Σ_b  Σ_{s_a, s_b} · L_{s_b, j}`` where every ``Σ_{s_a, s_b}``
    lies on the factor pattern (the closure property the reference's
    memoized scalar recursion relies on,
    ``g2o/core/marginal_covariance_cholesky.h:92`` ``computeEntry``).
    Pairs ``(srcS, transposed, srcL, dstW)`` are emitted vectorized,
    grouped by column length, and padded by the level indexing of
    :func:`build_schedule`; :func:`selected_inverse` walks the levels in
    REVERSE depth order (ancestor columns first)."""
    n = len(sym["rows"])
    colptr = np.asarray(sym["colptr"], dtype=np.int64)
    rows_flat = np.asarray(sym["rows_flat"], dtype=np.int64)
    depth = np.asarray(sym["depth"], dtype=np.int64)
    L = int(depth.max()) + 1 if n else 0
    lens = colptr[1:] - colptr[:-1]
    col_of_off = np.repeat(np.arange(n, dtype=np.int64), lens)
    key_all = col_of_off * (n + 1) + rows_flat

    def off_slot_v(i, j):
        return n + np.searchsorted(key_all, j * (n + 1) + i)

    srcS_l, tr_l, srcL_l, dstW_l, lvl_l = [], [], [], [], []
    for l in np.unique(lens):
        if l == 0:
            continue
        cols_l = np.nonzero(lens == l)[0]
        a, b = [x.ravel() for x in np.indices((int(l), int(l)))]
        base = colptr[cols_l][:, None]                    # (C, 1)
        sa = rows_flat[base + a[None, :]]                 # (C, P)
        sb = rows_flat[base + b[None, :]]
        srcL = n + base + b[None, :]
        dstW = base + a[None, :]                          # off index [0,nnz)
        eqm = sa == sb
        ltm = sa < sb
        # Σ_{sa,sb}: diag slot when equal; stored transposed when sa < sb
        srcS = np.where(eqm, sa,
                        np.where(ltm, off_slot_v(sb, sa),
                                 off_slot_v(sa, sb)))
        srcS_l.append(srcS.ravel())
        tr_l.append(ltm.ravel().astype(np.int64))
        srcL_l.append(np.broadcast_to(srcL, sa.shape).ravel())
        dstW_l.append(np.broadcast_to(dstW, sa.shape).ravel())
        lvl_l.append(np.repeat(depth[cols_l], len(a)))
    if srcS_l:
        payload = np.stack([np.concatenate(srcS_l), np.concatenate(tr_l),
                            np.concatenate(srcL_l), np.concatenate(dstW_l)],
                           axis=1)
        pairs = _pad_by_level(np.concatenate(lvl_l), payload, L)
    else:
        pairs = np.full((max(L, 1), 1, 4), -1, dtype=np.int64)
    return pairs


def selected_inverse(Lblocks, levels, n: int):
    """Block Takahashi recursion on the factor pattern.

    One reverse level-scheduled sweep computes ``Σ = H⁻¹`` restricted to
    the pattern of ``L`` (all diagonal blocks + every stored off-diagonal
    block) in ``O(Σ_j |struct(j)|²)`` batched block operations.  Per column
    ``j`` (batched across a level, ancestors already done):

    * ``Σ_{s,j} = −(Σ_b Σ_{s,s_b} L_{s_b,j}) L_jj⁻¹``  for ``s ∈ struct(j)``
    * ``Σ_{j,j} = L_jj⁻ᵀ L_jj⁻¹ − (Σ_s Σ_{s,j}ᵀ L_{s,j}) L_jj⁻¹``

    ``levels``: :func:`trim_levels` with the Takahashi pairs."""
    d = Lblocks.shape[-1]
    dtype, device = Lblocks.dtype, Lblocks.device
    eye = torch.eye(d, dtype=dtype, device=device)
    Sigma = torch.zeros_like(Lblocks)
    for lv in reversed(levels):
        s_slot = lv["s_slot"]
        cols = lv["cols"]
        Ljc = Lblocks[cols]
        invL = torch.linalg.solve_triangular(
            Ljc, eye.expand(Ljc.shape), upper=False)
        SigD = invL.mT @ invL
        if s_slot.numel():
            Sg = Sigma[lv["t_srcS"]]
            Sg = torch.where(lv["t_tr"][:, None, None], Sg.mT, Sg)
            C = Sg @ Lblocks[lv["t_srcL"]]
            W = Lblocks.new_zeros((s_slot.shape[0], d, d)).index_add_(
                0, lv["t_dst"], C)
            # X = −W L_jj⁻¹  ⇔  L_jjᵀ Xᵀ = −Wᵀ
            Xt = torch.linalg.solve_triangular(
                Lblocks[lv["s_col"]].mT, -W.mT, upper=True)
            Sigma[s_slot] = Xt.mT
            # R_j = Σ_s Σ_{s,j}ᵀ L_{s,j}, summed per column of the level
            R = Lblocks.new_zeros((cols.shape[0], d, d)).index_add_(
                0, lv["t_col"], Sigma[s_slot].mT @ Lblocks[s_slot])
            SigD = SigD - R @ invL
        Sigma[cols] = 0.5 * (SigD + SigD.mT)
    return Sigma


# --------------------------------------------------------------------- #
# solver class
# --------------------------------------------------------------------- #

class SparseCholeskySolver:
    """Direct block-sparse Cholesky solver.  The symbolic analysis runs
    once at setup; every ``solve`` re-runs the numeric phase with the
    current λ on the diagonal (the reference's setLambda/restoreDiagonal
    contract).

    Mixed vertex types are handled by PADDING every block to the maximum
    tangent dim ``d_max``: padding slots carry a decoupled unit diagonal,
    so the factor, solve and selected inverse stay one uniform batched
    schedule (the reference's variable-blocksize ``BlockSolverX``,
    ``core/block_solver.h:196``).  N-ary (hyper) edges contribute one H
    block per slot pair (``block_solver.hpp:142-214``); a slot pair bound
    to one vertex adds ``H_ab + H_abᵀ`` to its diagonal block."""

    name = "sparse_chol"

    def __init__(self, min_separator_size: int = 32):
        self.min_size = int(min_separator_size)
        self.aux = ()
        self._solve_fn = None
        self._setup_for = None

    def setup(self, problem, force: bool = False):
        """Symbolic analysis, level schedule and assembly maps for
        ``problem`` (a no-op when called again for the same problem)."""
        if self._setup_for is problem and not force:
            return self
        p = problem
        dev, dtype = p.device, p.dtype
        tnames = list(p.vertex_types)
        dims = {t: p.vertex_types[t].tangent_dim for t in tnames}
        d = max(dims.values())                       # padded block dim
        base = {}
        acc = 0
        for t in tnames:
            base[t] = acc
            acc += p.counts[t]
        n = acc
        # every edge row (gathered when this process holds a slice): a solve
        # on sharded data reads its rows' part of each map and completes
        # the assembled blocks with one all-reduce
        vidx_np = {name: full_rows(p.data, p.data.edges[name].vidx)
                   .cpu().numpy() for name in p.edge_types}

        # block pattern: ALL vertex pairs of every edge — n-ary edges
        # contribute each slot pair, as the reference builds its pattern
        # from whatever H blocks exist (``g2o/core/block_solver.hpp:142-214``)
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
        self._sym = sym                      # kept for the selected inverse
        self._n_blocks, self._block_dim = n, d
        self._type_base, self._dims = base, dims
        sched = build_schedule(sym, d)
        self._sched = sched
        inv = sym["inv"].astype(np.int64)
        off_slot_v = sched["off_slot_v"]

        def ten(x, dt=torch.int64):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=dt,
                                   device=dev)

        # per-(edge type, slot) diagonal ids and per-(edge type, slot pair)
        # maps for scattering H_ab blocks (block (hi, lo) with hi > lo
        # holds H[a,b] when inv[a] > inv[b], H[b,a] — the transpose —
        # otherwise)
        diag_ids, edge_maps, self_maps = {}, {}, {}
        for name, et in p.edge_types.items():
            vidx = vidx_np[name]
            for s in range(et.num_slots):
                diag_ids[(name, s)] = ten(base[et.vertex_types[s].name]
                                          + vidx[:, s])
            for a, b in slot_pairs[name]:
                ga = base[et.vertex_types[a].name] + vidx[:, a]
                gb = base[et.vertex_types[b].name] + vidx[:, b]
                i = inv[ga]
                j = inv[gb]
                valid = ga != gb
                lo = np.where(valid, np.minimum(i, j), 0)
                hi = np.where(valid, np.maximum(i, j), 1)
                slots = np.where(valid, off_slot_v(hi, lo), 0)
                edge_maps[(name, a, b)] = (ten(slots), ten(i < j, torch.bool),
                                           ten(valid, dtype))
                # both slots bind the SAME vertex: H_ab + H_abᵀ belongs to
                # its DIAGONAL block (rare; the extra scatter exists only
                # when present); row n is a spare row that is cut off
                if (~valid).any():
                    self_maps[(name, a, b)] = ten(np.where(valid, n, ga))

        # global (n,) fixed mask + per-slot validity (padding slots off)
        fixed_np = np.zeros(n, dtype=bool)
        valid_np = np.zeros((n, d), dtype=np.float64)
        for t in tnames:
            fixed_np[base[t]:base[t] + p.counts[t]] = \
                p.data.fixed[t].cpu().numpy()
            valid_np[base[t]:base[t] + p.counts[t], :dims[t]] = 1.0
        n_total = n + sched["nnz"]
        self.aux = dict(levels=trim_levels(sched, dev),
                        perm=ten(sym["perm"]), inv=ten(inv),
                        gfixed=ten(fixed_np, dtype),
                        gvalid=ten(valid_np, dtype),
                        diag_ids=diag_ids, edge_maps=edge_maps,
                        self_maps=self_maps)
        eye = torch.eye(d, dtype=dtype, device=dev)

        def _pad_block(M):
            """(E, a, b) -> (E, d, d) zero-padded top-left embedding."""
            a, b = M.shape[-2], M.shape[-1]
            if a == d and b == d:
                return M
            return torch.nn.functional.pad(M, (0, d - b, 0, d - a))

        def assemble_and_factor(data, lin, lam, aux):
            """Scatter the H blocks into the (permuted) L pattern and run
            the level-scheduled numeric factorization."""
            diag = torch.zeros((n + 1, d, d), dtype=dtype, device=dev)
            for name, et in p.edge_types.items():
                Js = p.edge_jacs(lin, name)
                W = p.edge_weights(lin, name)
                lo, nr = row_window(data, name)
                for s in range(et.num_slots):
                    Hss = torch.einsum("erd,ers,esf->edf", Js[s], W, Js[s])
                    diag.index_add_(0, aux["diag_ids"][(name, s)][lo:lo + nr],
                                    _pad_block(Hss))
            # same-vertex slot pairs: H_ab + H_abᵀ into the diagonal block
            for (name, a, b), sids in aux["self_maps"].items():
                Js = p.edge_jacs(lin, name)
                W = p.edge_weights(lin, name)
                lo, nr = row_window(data, name)
                Hab = _pad_block(torch.einsum("erd,ers,esf->edf", Js[a], W,
                                              Js[b]))
                diag.index_add_(0, sids[lo:lo + nr], Hab + Hab.mT)
            # off-diagonal H blocks (every slot pair of every edge); the
            # diagonal slots are written below (an invalid pair adds zero
            # into slot 0 only)
            blocks = torch.zeros((n_total, d, d), dtype=dtype, device=dev)
            for name, et in p.edge_types.items():
                if not slot_pairs[name]:
                    continue
                Js = p.edge_jacs(lin, name)
                W = p.edge_weights(lin, name)
                lo, nr = row_window(data, name)
                for a, b in slot_pairs[name]:
                    Hab = _pad_block(torch.einsum("erd,ers,esf->edf", Js[a],
                                                  W, Js[b]))
                    slots, transpose, valid = (
                        m[lo:lo + nr] for m in aux["edge_maps"][(name, a, b)])
                    Hab = torch.where(transpose[:, None, None], Hab.mT, Hab)
                    blocks.index_add_(0, slots, Hab * valid[:, None, None])
            edge_sum_(data, diag, blocks)
            # damping on valid slots, unit diagonal on padding slots,
            # identity on fixed vertices
            vmask = aux["gvalid"]                       # (n, d)
            diag = diag[:n] + torch.diag_embed(vmask * lam + (1.0 - vmask))
            fx = aux["gfixed"][:, None, None]
            diag = diag * (1.0 - fx) + eye * fx
            blocks[:n] = diag[aux["perm"]]
            return factorize(blocks, aux["levels"])

        def to_full(blocks):
            full = torch.zeros((n, d), dtype=dtype, device=dev)
            for t in tnames:
                full[base[t]:base[t] + p.counts[t], :dims[t]] = blocks[t]
            return full

        def solve(data, lin, lam, aux):
            blocks = assemble_and_factor(data, lin, lam, aux)
            bperm = to_full(p.split_tangent(lin.b))[aux["perm"]]
            x = solve_factored(blocks, bperm, aux["levels"])[aux["inv"]]
            return p.join_tangent({t: x[base[t]:base[t] + p.counts[t],
                                        :dims[t]] for t in tnames})

        self._factor_fn = assemble_and_factor  # used by marginal recovery
        self._solve_fn = solve
        self._setup_for = problem
        return self

    def solve(self, data, lin, lam=0.0):
        return self._solve_fn(data, lin, lam, self.aux)
