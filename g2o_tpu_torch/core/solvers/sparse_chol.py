"""Block-sparse Cholesky, symbolic part — port of the host symbolic
machinery of ``g2o_tpu/core/solvers/sparse_chol.py``.

The fill-reducing ordering (recursive BFS-separator nested dissection),
the elimination tree and the exact block structure of L, computed once per
graph pattern on the host (the analogue of the reference's symbolic AMD
analysis reused across iterations, ``linear_solver_csparse.h:71``).  The
native path runs the JAX package's own ``symchol.cpp``
(:mod:`g2o_tpu_torch.native`), so both packages order every graph the
same way; without a compiler the pure-Python path below runs instead.

The level-scheduled numeric ``SparseCholeskySolver`` is not ported yet;
:mod:`g2o_tpu_torch.core.solvers.supernodal` consumes this module.
"""

from __future__ import annotations

import numpy as np


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
