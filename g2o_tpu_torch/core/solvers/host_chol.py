"""Host direct sparse Cholesky — the hybrid card/host backend, port of
``g2o_tpu/core/solvers/host_chol.py``.

The reference's direct solvers run a SEQUENTIAL f64 sparse factorization
on a host core (CSparse ``cs_chol``:
``g2o/solvers/csparse/linear_solver_csparse.h:107``; CHOLMOD:
``solvers/cholmod/linear_solver_cholmod.h:76``).  This solver splits a
step the same way:

* **card**: the linearization and the H/b block production (the diagonal
  blocks come with the linearization, the off-diagonal blocks from one
  einsum per vertex pair of every edge), packed into one float64 buffer
  and copied to the host once;
* **host**: the blocks scattered into an upper-CSC value array, then the
  scalar up-looking sparse Cholesky of the port's ``native/hostchol.cpp``
  over a fill-reducing nested-dissection block ordering
  (``native/symchol.cpp``); ``dx`` goes back to the card in one copy.

n-ary edges put every vertex pair into the pattern (the reference builds
its pattern from whatever H blocks exist,
``g2o/core/block_solver.hpp:142-214``); mixed vertex types keep their true
block dims.  A non-PD factorization returns a NaN step (the reference's
csparse failure branch, ``linear_solver_csparse.h:128``).  On sharded data
(``ProblemData.group``) every process gathers the off-diagonal blocks of
all edge rows (one all-reduce of a zeroed full buffer per block type) and
runs the same host factorization.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from g2o_tpu_torch.core.problem import full_rows
from g2o_tpu_torch.core.solvers.sparse_chol import symbolic_factorization


class HostCholSolver:
    """Direct f64 sparse Cholesky on the host CPU (native C++ numeric
    phase) with the H/b blocks produced on the problem's device.  It runs
    under host loops only (``SparseOptimizer``, :func:`optimize_gn_host`)."""

    name = "host_chol"

    def __init__(self, min_separator_size: int = 32):
        self.min_size = int(min_separator_size)
        self._base_cache = (None, None)   # (lin, (Ax, bh)) at λ = 0
        self._p = None

    def setup(self, problem, force: bool = False):
        """Symbolic analysis and the scatter maps of ``problem``, redone
        on every call (``force`` is accepted for the solvers' common
        signature)."""
        p = problem
        self._p = p
        tnames = list(p.vertex_types)
        dims = {t: p.vertex_types[t].tangent_dim for t in tnames}
        base, acc = {}, 0
        for t in tnames:
            base[t] = acc
            acc += p.counts[t]
        n = acc
        # every edge row (gathered when this process holds a slice): a
        # solve on sharded data gathers the off-diagonal blocks too, and
        # every process factors the same matrix on its host
        vidx_np = {name: full_rows(p.data, p.data.edges[name].vidx).cpu()
                   .numpy()
                   for name in p.edge_types}

        # block pattern: ALL vertex pairs of every edge (n-ary included)
        pair_set = set()
        edge_pairs = {}                   # name -> list of (sa, sb) slots
        for name, et in p.edge_types.items():
            vidx = vidx_np[name]
            k = et.num_slots
            edge_pairs[name] = [(a, b) for a in range(k)
                                for b in range(a + 1, k)]
            for a, b in edge_pairs[name]:
                ga = base[et.vertex_types[a].name] + vidx[:, a]
                gb = base[et.vertex_types[b].name] + vidx[:, b]
                lo, hi = np.minimum(ga, gb), np.maximum(ga, gb)
                m = lo != hi
                pair_set.update(zip(lo[m].tolist(), hi[m].tolist()))
        pairs = np.asarray(sorted(pair_set), dtype=np.int64).reshape(-1, 2)

        sym = symbolic_factorization(n, pairs, min_size=self.min_size)
        perm = sym["perm"].astype(np.int64)      # new k -> old block id
        inv = sym["inv"].astype(np.int64)        # old block id -> new k

        # scalar layout of the PERMUTED system (true block dims)
        bdim = np.empty(n, dtype=np.int64)
        btype = np.empty(n, dtype=object)
        blocal = np.empty(n, dtype=np.int64)
        for t in tnames:
            sl = slice(base[t], base[t] + p.counts[t])
            bdim[sl], btype[sl] = dims[t], t
            blocal[sl] = np.arange(p.counts[t])
        pdim = bdim[perm]                         # dim per permuted block
        soff = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(pdim, out=soff[1:])
        N = int(soff[-1])                         # total scalar dim

        # flat-tangent index per permuted scalar (for b / dx permutation)
        scal_from_flat = np.empty(N, dtype=np.int64)
        for k in range(n):
            g = perm[k]
            t = btype[g]
            flat0 = p.type_bases[t] + blocal[g] * dims[t]
            scal_from_flat[soff[k]:soff[k + 1]] = flat0 + np.arange(dims[t])

        # --- upper-CSC scalar pattern --------------------------------- #
        rows_l, cols_l = [], []
        # diagonal blocks: upper triangle within each block
        for d in np.unique(pdim):
            ks = np.nonzero(pdim == d)[0]
            iu, ju = np.triu_indices(int(d))
            rows_l.append((soff[ks][:, None] + iu[None, :]).ravel())
            cols_l.append((soff[ks][:, None] + ju[None, :]).ravel())
        # off-diagonal block pairs (permuted lo < hi): full d_lo × d_hi
        if len(pairs):
            plo, phi = inv[pairs[:, 0]], inv[pairs[:, 1]]
            plo2, phi2 = np.minimum(plo, phi), np.maximum(plo, phi)
            for dl in np.unique(pdim[plo2]):
                for dh in np.unique(pdim[phi2]):
                    m = (pdim[plo2] == dl) & (pdim[phi2] == dh)
                    if not m.any():
                        continue
                    r, c = [x.ravel() for x in
                            np.indices((int(dl), int(dh)))]
                    rows_l.append((soff[plo2[m]][:, None]
                                   + r[None, :]).ravel())
                    cols_l.append((soff[phi2[m]][:, None]
                                   + c[None, :]).ravel())
        rows = np.concatenate(rows_l)
        cols = np.concatenate(cols_l)
        order = np.lexsort((rows, cols))
        rows, cols = rows[order], cols[order]
        key_all = cols * N + rows                 # globally ascending
        nnz = rows.shape[0]
        Ap = np.zeros(N + 1, dtype=np.int64)
        np.add.at(Ap, cols + 1, 1)
        Ap = np.cumsum(Ap)
        Ai = rows.astype(np.int32)

        def pos_of(r, c):
            return np.searchsorted(key_all, c * N + r)

        # --- value scatter maps --------------------------------------- #
        # diag blocks per type: (N_t, d, d) -> upper-triangle positions
        diag_maps = {}
        for t in tnames:
            iu, ju = np.triu_indices(dims[t])
            ks = inv[base[t] + np.arange(p.counts[t])]
            diag_maps[t] = (pos_of(soff[ks][:, None] + iu[None, :],
                                   soff[ks][:, None] + ju[None, :]), iu, ju)

        # per edge type / slot pair: (E, da, db) H_ab blocks
        off_maps, self_maps = {}, {}
        for name, et in p.edge_types.items():
            vidx = vidx_np[name]
            for a, b in edge_pairs[name]:
                ta, tb = et.vertex_types[a].name, et.vertex_types[b].name
                da, db = dims[ta], dims[tb]
                pa = inv[base[ta] + vidx[:, a]]
                pb = inv[base[tb] + vidx[:, b]]
                valid = pa != pb
                i, j = [x.ravel() for x in np.indices((da, db))]
                # H_ab[i, j] lands at (row=soff[pa]+i, col=soff[pb]+j) when
                # pa < pb, transposed otherwise
                ra = soff[pa][:, None] + i[None, :]
                cb = soff[pb][:, None] + j[None, :]
                r = np.where((pa < pb)[:, None], ra, cb)
                c = np.where((pa < pb)[:, None], cb, ra)
                posm = pos_of(r, c)
                posm[~valid] = 0          # masked below
                off_maps[(name, a, b)] = (posm, valid)
                # both slots bind the SAME vertex: H_ab + H_abᵀ belongs to
                # that vertex's DIAGONAL block
                if (~valid).any():
                    sel = np.nonzero(~valid)[0]
                    iu, ju = np.triu_indices(da)
                    rs = soff[pa[sel]][:, None] + iu[None, :]
                    cs = soff[pa[sel]][:, None] + ju[None, :]
                    self_maps[(name, a, b)] = (pos_of(rs, cs), sel, iu, ju)

        # diagonal scalar positions (for λ damping / fixed identity)
        alld = np.arange(N, dtype=np.int64)
        diag_pos = pos_of(alld, alld)
        fixed_scal = np.zeros(N, dtype=bool)
        for t in tnames:
            fx = p.data.fixed[t].cpu().numpy().astype(bool)
            for k in inv[base[t] + np.nonzero(fx)[0]]:
                fixed_scal[soff[k]:soff[k + 1]] = True
        self._lam_pos = diag_pos[~fixed_scal]
        self._fix_pos = diag_pos[fixed_scal]

        from g2o_tpu_torch.native import HostCholesky

        self._hc = HostCholesky(N, Ap, Ai)
        self._nnz = nnz
        self._N = N
        self._scal_from_flat = scal_from_flat
        self._diag_maps = diag_maps
        self._off_maps = off_maps
        self._self_maps = self_maps
        self._edge_pairs = edge_pairs
        # the packed buffer's pieces, in order: (key, shape)
        self._layout = (
            [(("diag", t), (p.counts[t], dims[t], dims[t])) for t in tnames]
            + [(key, (vidx_np[key[0]].shape[0],
                      dims[p.edge_types[key[0]].vertex_types[key[1]].name],
                      dims[p.edge_types[key[0]].vertex_types[key[2]].name]))
               for key in off_maps]
            + [(("b",), (p.total_dim,)), (("chi2",), (1,))])
        self._base_cache = (None, None)
        return self

    # ------------------------------------------------------------------ #
    # card side
    # ------------------------------------------------------------------ #

    def _off_blocks(self, lin, data):
        """Off-diagonal ``H_ab = J_aᵀ W J_b`` blocks, one einsum per slot
        pair: ``{(name, a, b): (E, d_a, d_b)}``, of every edge row (gathered
        from the processes of sharded data)."""
        p = self._p
        out = {}
        for name, pairs in self._edge_pairs.items():
            if not pairs:
                continue
            Js = p.edge_jacs(lin, name)
            W = p.edge_weights(lin, name)
            for a, b in pairs:
                out[(name, a, b)] = full_rows(data, torch.einsum(
                    "erd,ers,esf->edf", Js[a], W, Js[b]))
        return out

    def _fetch(self, lin, data=None):
        """The diagonal and off-diagonal blocks, ``b`` and the robust chi2
        of ``lin`` (over ``data``, the problem's by default) in float64 on
        the host, through ONE device→host copy: ``(diag, off, b, chi2)`` as
        numpy views of the packed buffer."""
        off = self._off_blocks(lin, self._p.data if data is None else data)
        parts = []
        for key, _ in self._layout:
            if key[0] == "diag":
                parts.append(lin.diag[key[1]])
            elif key == ("b",):
                parts.append(lin.b)
            elif key == ("chi2",):
                parts.append(lin.chi2_robust)
            else:
                parts.append(off[key])
        flat = torch.cat([x.reshape(-1).to(torch.float64) for x in parts])
        host = flat.cpu().numpy()
        diag, offh, b, chi2 = {}, {}, None, None
        pos = 0
        for key, shape in self._layout:
            size = math.prod(shape)
            view = host[pos:pos + size].reshape(shape)
            pos += size
            if key[0] == "diag":
                diag[key[1]] = view
            elif key == ("b",):
                b = view
            elif key == ("chi2",):
                chi2 = float(view[0])
            else:
                offh[key] = view
        return diag, offh, b, chi2

    # ------------------------------------------------------------------ #
    # host side
    # ------------------------------------------------------------------ #

    def _scatter_ax(self, diag, off):
        """Scatter the fetched block values into the upper-CSC value
        array."""
        idx_l, val_l = [], []
        for t, (posm, iu, ju) in self._diag_maps.items():
            idx_l.append(posm.ravel())
            val_l.append(diag[t][:, iu, ju].ravel())
        for key, (posm, valid) in self._off_maps.items():
            H = off[key]
            E, da, db = H.shape
            idx_l.append(posm[valid].ravel())
            val_l.append(H.reshape(E, da * db)[valid].ravel())
        for key, (posm, sel, iu, ju) in self._self_maps.items():
            # same-vertex slot pairs: H_ab + H_abᵀ into the diagonal block
            H = off[key][sel]
            Hs = H + np.swapaxes(H, 1, 2)
            idx_l.append(posm.ravel())
            val_l.append(Hs[:, iu, ju].ravel())
        Ax = np.bincount(np.concatenate(idx_l),
                         weights=np.concatenate(val_l),
                         minlength=self._nnz)
        # fixed vertices: unit diagonal (their H contributions are
        # already zero — Jacobian slots masked at linearize)
        Ax[self._fix_pos] += 1.0
        return Ax

    def _factor_solve(self, Ax, bh, lam):
        """λ-damp, factor, solve, un-permute: the flat-tangent float64 dx
        (NaN when the matrix is not PD)."""
        if lam:
            Ax[self._lam_pos] += float(lam)
        if self._hc.factor(Ax) != 0:
            return np.full(self._N, np.nan)
        x = self._hc.solve(bh)
        dx = np.zeros(self._N, dtype=np.float64)
        dx[self._scal_from_flat] = x
        return dx

    def _fill_and_solve(self, diag, off, b, lam):
        """Host side of a step: scatter, factor, solve."""
        Ax = self._scatter_ax(diag, off)
        return self._factor_solve(Ax, b[self._scal_from_flat], lam)

    def _base_ax(self, lin, data):
        """The λ = 0 value array and permuted ``b`` of ``lin`` (cached per
        linearization; the cache holds ``lin`` itself, so its identity
        cannot be reused)."""
        if self._base_cache[0] is lin:
            return self._base_cache[1]
        diag, off, b, _ = self._fetch(lin, data)
        res = (self._scatter_ax(diag, off), b[self._scal_from_flat])
        self._base_cache = (lin, res)
        return res

    def solve(self, data, lin, lam=0.0):
        p = self._p
        Ax0, bh = self._base_ax(lin, data)
        dx = self._factor_solve(Ax0.copy(), bh, lam)
        return torch.as_tensor(dx, dtype=p.dtype).to(p.device)


def optimize_gn_host(problem, solver, n_iters, lam=0.0):
    """Host-loop Gauss-Newton over the hybrid solver with the fewest
    transfers: per iteration ONE device→host copy (linearize + H/b blocks
    + chi2, packed) and ONE host→device copy (dx).  ``lam`` adds constant
    Tikhonov damping (0 = pure GN, the reference gn_var,
    ``optimization_algorithm_gauss_newton.cpp:50``).  Stops at a NaN step.

    Returns ``{"chi2_per_iteration", "chi2_final", "iter_walls",
    "wall_s", "iterations"}`` (the JAX package's keys) plus
    ``host_walls``: each iteration's host time (scatter + factor + solve);
    the rest of its wall is the card's (linearize, blocks, copies)."""
    p = problem
    if solver._p is not p:
        solver.setup(p)
    est = p.estimates
    chis, iter_walls, host_walls = [], [], []
    t0 = time.perf_counter()
    for _ in range(n_iters):
        t1 = time.perf_counter()
        lin = p.linearize_fn(p.data, est)
        diag, off, b, chi2 = solver._fetch(lin)
        chis.append(chi2)
        t2 = time.perf_counter()
        dx = solver._fill_and_solve(diag, off, b, lam)
        host_walls.append(time.perf_counter() - t2)
        if not np.all(np.isfinite(dx)):
            iter_walls.append(time.perf_counter() - t1)
            break
        est = p.apply_update_fn(
            p.data, est, torch.as_tensor(dx, dtype=p.dtype).to(p.device))
        iter_walls.append(time.perf_counter() - t1)
    if p.device.type == "cuda":
        torch.cuda.synchronize(p.device)
    wall = time.perf_counter() - t0
    chi2_final = float(p.chi2_fn(p.data, est)[0])
    p.set_estimates(est)
    return {"chi2_per_iteration": chis, "chi2_final": chi2_final,
            "iter_walls": iter_walls, "host_walls": host_walls,
            "wall_s": wall, "iterations": len(iter_walls)}
