"""Matrix-free preconditioned conjugate gradient — port of
``g2o_tpu/core/solvers/pcg.py``.

The Hessian is never formed: ``H·v = Σ Jᵀ(W(J v))`` comes from the cached
per-edge Jacobians (:meth:`Problem.hvp_operator`).  The recurrence runs in
block layout (``{type: (N_t, d_t)}``) as a Python loop; its stop test
reads one scalar from the device per CG iteration.

Preconditioners:

* ``"jacobi"`` — per-vertex diagonal block inverses;
* ``"chunk"`` — consecutive vertices grouped into chunks of ``chunk_size``;
  each chunk's diagonal blocks plus its odometry-chain couplings are
  inverted exactly, once per λ-trial, by one batched Cholesky;
* ``"chunk2"`` — two-level additive Schwarz: the chunk solves capture ALL
  intra-chunk couplings, and a coarse correction solves the chunk-graph
  system ``Rᵀ(H+λI)R`` exactly.  The coarse matrix is inverted as
  ``L⁻ᵀL⁻¹`` with the batched Cholesky and forward-substitution kernels
  (K1, K2) once per λ-trial.

Only ``precond_mode="per_solve"`` is ported so far.
"""

from __future__ import annotations

import numpy as np
import torch

from g2o_tpu_torch.core.solvers.supernodal import (_chol_batched,
                                                   _solve_lower_batched)
from g2o_tpu_torch.ops.smallblocks import inv_small

# coarse systems are padded to a multiple of this many columns (the JAX
# package's Cholesky panel width); past one panel they reach K1/K2
_PANEL = 96


class PCGSolver:
    def __init__(self, max_iter: int = 100, tol: float = 1e-6,
                 precond: str = "jacobi", chunk_size: int = 32,
                 absolute_tolerance: bool = True, carry_factor: float = 0.5,
                 matvec_precision: str = "default",
                 precond_mode: str = "per_solve"):
        if precond not in ("jacobi", "chunk", "chunk2"):
            raise ValueError(f"unknown precond {precond!r}")
        if precond_mode in ("frozen", "every_k"):
            raise NotImplementedError(
                f"precond_mode={precond_mode!r} is not ported yet")
        if precond_mode != "per_solve":
            raise ValueError(f"unknown precond_mode {precond_mode!r}")
        # accepted for API parity: TF32 is off package-wide, so the CG
        # matvec runs in full precision either way
        if matvec_precision not in ("default", "highest"):
            raise ValueError(f"unknown matvec_precision {matvec_precision!r}")
        self.max_iter = int(max_iter)
        self.tol = float(tol)
        self.precond = precond
        self.chunk_size = int(chunk_size)
        self.precond_mode = precond_mode
        self.matvec_precision = matvec_precision
        # reference-PCG absoluteTolerance continuation: each solve's stop
        # threshold is floored by carry_factor x the previous solve's final
        # residual² (solvers/pcg/linear_solver_pcg.hpp:124-127,149)
        self.absolute_tolerance = bool(absolute_tolerance)
        self.carry_factor = float(carry_factor)
        self.state0 = None
        self._host_state = None
        self._setup_for = None

    # ------------------------------------------------------------------ #
    # setup: host-side index maps
    # ------------------------------------------------------------------ #

    def setup(self, problem, force: bool = False):
        """Build the preconditioner index maps for ``problem`` (a no-op when
        called again for the same problem)."""
        if self._setup_for is problem and not force:
            return self
        self._setup_for = None
        self.problem = problem
        self._chunk = (self._chunk_setup(problem)
                       if self.precond in ("chunk", "chunk2") else None)
        self.state0 = (torch.tensor(-1.0, dtype=problem.dtype,
                                    device=problem.device)
                       if self.absolute_tolerance else None)
        self._host_state = None
        self._setup_for = problem
        return self

    def _chunk_setup(self, p):
        """Index maps of the chunked preconditioners.  Vertices get GLOBAL
        block ids (type base + local index), every block is padded to the
        largest tangent dim ``d`` (padding slots carry a unit diagonal), and
        chunks group consecutive global ids.  Only binary edges couple
        blocks."""
        dev = p.device
        tnames = list(p.vertex_types)
        dims = {t: p.vertex_types[t].tangent_dim for t in tnames}
        d = max(dims.values())
        base, acc = {}, 0
        for t in tnames:
            base[t] = acc
            acc += p.counts[t]
        n = acc
        c = self.chunk_size
        nc = -(-n // c)
        cfg = dict(tnames=tnames, dims=dims, base=base, d=d, n=n, c=c, nc=nc,
                   n_pad=nc * c, ncd=nc * d,
                   ncd_pad=-(-(nc * d) // _PANEL) * _PANEL, maps={})

        def ten(x):
            return torch.as_tensor(x, dtype=torch.int64, device=dev)

        for name, et in p.edge_types.items():
            if et.num_slots != 2:
                continue
            vidx = p.data.edges[name].vidx.cpu().numpy()
            ga = base[et.vertex_types[0].name] + vidx[:, 0]
            gb = base[et.vertex_types[1].name] + vidx[:, 1]
            if self.precond == "chunk":
                # chain: edges between consecutive global ids of one chunk
                lo, hi = np.minimum(ga, gb), np.maximum(ga, gb)
                sel = np.nonzero((hi == lo + 1) & (lo // c == hi // c))[0]
                cfg["maps"][name] = dict(
                    sel=ten(sel),
                    fwd=torch.as_tensor(ga[sel] < gb[sel], device=dev),
                    ci=ten(lo[sel] // c), li=ten(lo[sel] % c))
            else:
                # intra: ALL same-chunk couplings; coarse: every edge
                sel = np.nonzero(ga // c == gb // c)[0]
                cfg["maps"][name] = dict(
                    sel=ten(sel), ci=ten(ga[sel] // c),
                    l0=ten(ga[sel] % c), l1=ten(gb[sel] % c),
                    ca=ten(ga // c), cb=ten(gb // c))
        # slot s of chunk k is live when a NON-FIXED vertex of the chunk has
        # tangent dim > s; dead slots get a unit coarse diagonal (SPD)
        cover = np.zeros((nc, d))
        gfm = np.zeros((n, d))
        for t in tnames:
            live = ~p.data.fixed[t].cpu().numpy()
            g = base[t] + np.arange(p.counts[t])
            if live.any():
                cover[np.unique(g[live] // c), :dims[t]] = 1.0
            gfm[g, :dims[t]] = live[:, None]
        cfg["cover"] = torch.as_tensor(cover, dtype=p.dtype, device=dev)
        # global free mask (n, d) of the coarse prolongation
        cfg["gfm"] = torch.as_tensor(gfm, dtype=p.dtype, device=dev)
        return cfg

    # ------------------------------------------------------------------ #
    # preconditioner build / apply
    # ------------------------------------------------------------------ #

    def build_precond(self, data, lin, lam):
        """The preconditioner for ``H + λI`` (once per λ-trial)."""
        if self._chunk is None:
            return self._build_jacobi(data, lin, lam)
        Hab = self._pair_blocks(lin)
        minv = self._build_chunk_blocks(data, lin, lam, Hab)
        if self.precond == "chunk2":
            return minv, self._invert_coarse(
                self._assemble_coarse(data, lin, lam, Hab))
        return minv

    def apply_precond(self, data, minv, rb):
        if self._chunk is None:
            return {t: torch.einsum("nij,nj->ni", minv[t], rb[t]) for t in rb}
        cfg = self._chunk
        n, nc, c, d = cfg["n"], cfg["nc"], cfg["c"], cfg["d"]
        if self.precond == "chunk2":
            minv, cinv = minv
        rv = self._stacked_vec(rb, cfg["n_pad"])
        y = torch.einsum("cij,cj->ci", minv, rv.reshape(nc, c * d))
        z = y.reshape(-1, d)[:n]
        if self.precond == "chunk2":
            rm = rv * self._pad_rows(cfg["gfm"], cfg["n_pad"])
            rc = rm.reshape(nc, c, d).sum(dim=1).reshape(-1)
            rc = torch.nn.functional.pad(rc, (0, cfg["ncd_pad"] - cfg["ncd"]))
            zc = (cinv @ rc)[:cfg["ncd"]].reshape(nc, d)
            z = z + cfg["gfm"] * zc.repeat_interleave(c, dim=0)[:n]
        base, counts = cfg["base"], self.problem.counts
        return {t: z[base[t]:base[t] + counts[t], :cfg["dims"][t]]
                for t in cfg["tnames"]}

    def _build_jacobi(self, data, lin, lam):
        minv = {}
        for t, vt in self.problem.vertex_types.items():
            eye = torch.eye(vt.tangent_dim, dtype=self.problem.dtype,
                            device=self.problem.device)
            blocks = lin.diag[t] + lam * eye
            # fixed vertices (zero rows in J) get a unit block -> dx = 0
            fx = data.fixed[t].to(blocks.dtype)[:, None, None]
            minv[t] = inv_small(blocks * (1.0 - fx) + eye * fx)
        return minv

    @staticmethod
    def _pad_rows(x, rows):
        return torch.nn.functional.pad(x, (0, 0) * (x.dim() - 1)
                                       + (0, rows - x.shape[0]))

    def _pad_block(self, M):
        """(E, a, b) -> (E, d, d) zero-padded embedding."""
        d = self._chunk["d"]
        return torch.nn.functional.pad(M, (0, d - M.shape[-1],
                                           0, d - M.shape[-2]))

    def _pair_blocks(self, lin):
        """Off-diagonal blocks ``H_ab = J_aᵀ W J_b`` of every binary edge,
        padded to ``(E, d, d)``."""
        out = {}
        for name in self._chunk["maps"]:
            Ja, Jb = self.problem.edge_jacs(lin, name)
            out[name] = self._pad_block(torch.einsum(
                "erd,ers,esf->edf", Ja, self.problem.edge_weights(lin, name),
                Jb))
        return out

    def _stacked_diag(self, data, lin, lam, fixed_identity):
        """Global ``(n, d, d)`` damped diagonal.  ``fixed_identity``: fixed
        vertices get an identity block and padding slots a unit diagonal
        (the chunk level); otherwise both are zero (the coarse level)."""
        cfg, p = self._chunk, self.problem
        d = cfg["d"]
        D = torch.zeros((cfg["n"], d, d), dtype=p.dtype, device=p.device)
        for t in cfg["tnames"]:
            dt = cfg["dims"][t]
            eye = torch.eye(dt, dtype=p.dtype, device=p.device)
            fx = data.fixed[t].to(p.dtype)[:, None, None]
            blk = (lin.diag[t] + lam * eye) * (1.0 - fx)
            if fixed_identity:
                blk = blk + eye * fx
            blk = self._pad_block(blk)
            if fixed_identity and dt < d:
                pad_eye = torch.zeros(d, dtype=p.dtype, device=p.device)
                pad_eye[dt:] = 1.0
                blk = blk + torch.diag(pad_eye)
            b = cfg["base"][t]
            D[b:b + p.counts[t]] = blk
        return D

    def _stacked_vec(self, rb, rows):
        """``{type: (N_t, d_t)}`` -> global ``(rows, d)`` zero-padded."""
        cfg, p = self._chunk, self.problem
        v = torch.zeros((rows, cfg["d"]), dtype=p.dtype, device=p.device)
        for t in cfg["tnames"]:
            b = cfg["base"][t]
            v[b:b + p.counts[t], :cfg["dims"][t]] = rb[t]
        return v

    def _build_chunk_blocks(self, data, lin, lam, Hab):
        cfg = self._chunk
        nc, c, d = cfg["nc"], cfg["c"], cfg["d"]
        D = self._stacked_diag(data, lin, lam, fixed_identity=True)
        if cfg["n_pad"] > cfg["n"]:
            eye = torch.eye(d, dtype=D.dtype, device=D.device)
            D = torch.cat([D, eye.expand(cfg["n_pad"] - cfg["n"], d, d)])
        M = torch.zeros((nc, c, c, d, d), dtype=D.dtype, device=D.device)
        ar = torch.arange(c, device=D.device)
        M[:, ar, ar] = D.reshape(nc, c, d, d)
        for name, m in cfg["maps"].items():
            H = Hab[name][m["sel"]]
            if self.precond == "chunk2":
                M.index_put_((m["ci"], m["l0"], m["l1"]), H, accumulate=True)
                M.index_put_((m["ci"], m["l1"], m["l0"]), H.transpose(1, 2),
                             accumulate=True)
            else:
                # chain coupling oriented as block (lo, lo + 1)
                O = torch.where(m["fwd"][:, None, None], H, H.transpose(1, 2))
                M.index_put_((m["ci"], m["li"], m["li"] + 1), O,
                             accumulate=True)
                M.index_put_((m["ci"], m["li"] + 1, m["li"]),
                             O.transpose(1, 2), accumulate=True)
        Md = M.permute(0, 1, 3, 2, 4).reshape(nc, c * d, c * d)
        # explicit inverse once per λ-trial: each CG application is then a
        # single batched matvec
        return torch.cholesky_inverse(torch.linalg.cholesky(Md))

    def _assemble_coarse(self, data, lin, lam, Hab):
        """``Hc = Rᵀ(H+λI)R`` over non-fixed vertices, ``(ncd_pad, ncd_pad)``:
        vertex diagonals aggregate onto coarse diagonal blocks, every edge
        block onto its (chunk_a, chunk_b) entry and its transpose."""
        cfg = self._chunk
        nc, c, d = cfg["nc"], cfg["c"], cfg["d"]
        Dm = self._pad_rows(self._stacked_diag(data, lin, lam,
                                               fixed_identity=False),
                            cfg["n_pad"])
        S = torch.zeros((nc, nc, d, d), dtype=Dm.dtype, device=Dm.device)
        for name, m in cfg["maps"].items():
            S.index_put_((m["ca"], m["cb"]), Hab[name], accumulate=True)
        Hc = S + S.transpose(0, 1).transpose(2, 3)
        di = torch.arange(nc, device=Dm.device)
        Hc[di, di] += (Dm.reshape(nc, c, d, d).sum(dim=1)
                       + torch.diag_embed(1.0 - cfg["cover"]))
        Hd = Hc.permute(0, 2, 1, 3).reshape(cfg["ncd"], cfg["ncd"])
        pad = cfg["ncd_pad"] - cfg["ncd"]
        if pad:
            Hd = torch.nn.functional.pad(Hd, (0, pad, 0, pad))
            tail = torch.arange(cfg["ncd"], cfg["ncd_pad"], device=Hd.device)
            Hd[tail, tail] = 1.0
        return Hd

    def _invert_coarse(self, Hd):
        """``Hc⁻¹ = L⁻ᵀL⁻¹``: K1 factors, K2 forms ``L⁻¹`` (``B = I``)."""
        L = _chol_batched(Hd[None], _PANEL)
        eye = torch.eye(Hd.shape[0], dtype=Hd.dtype, device=Hd.device)[None]
        Linv = _solve_lower_batched(L, eye, _PANEL)[0]
        return Linv.T @ Linv

    # ------------------------------------------------------------------ #
    # the CG recurrence
    # ------------------------------------------------------------------ #

    def cg(self, data, lin, lam, minv, carry=None):
        """Run PCG on ``(H + λI) dx = b`` with a built preconditioner.
        Returns ``(dx (T,), stats)``."""
        p = self.problem
        hvp = p.hvp_operator(data, lin)
        fmask = {t: data.fixed[t].to(p.dtype)[:, None] for t in p.vertex_types}

        def matvec(vb):
            # damped system with unit rows on fixed slots
            hv = hvp(vb)
            return {t: hv[t] + lam * vb[t] + fmask[t] * (vb[t] - lam * vb[t])
                    for t in p.vertex_types}

        tdot = p.tree_dot
        b = p.split_tangent(lin.b)
        x = {t: torch.zeros_like(v) for t, v in b.items()}
        r = dict(b)
        z = self.apply_precond(data, minv, r)
        pv = z
        rz = tdot(r, z)
        thresh = self.tol * self.tol * tdot(b, b)
        if carry is not None:
            # residual continuation: successive LM solves deepen by one
            # carry_factor step each (reference absoluteTolerance)
            thresh = torch.maximum(thresh, carry.to(thresh.dtype))
        it = 0
        rr = tdot(r, r)
        while it < self.max_iter and bool(rr > thresh):
            Ap = matvec(pv)
            alpha = rz / tdot(pv, Ap)
            x = {t: x[t] + alpha * pv[t] for t in x}
            r = {t: r[t] - alpha * Ap[t] for t in r}
            z = self.apply_precond(data, minv, r)
            rz_new = tdot(r, z)
            beta = rz_new / rz
            pv = {t: z[t] + beta * pv[t] for t in z}
            rz = rz_new
            rr = tdot(r, r)
            it += 1
        stats = {"cg_iterations": it, "residual2": rr,
                 "carry": self.carry_factor * rr}
        return p.join_tangent(x), stats

    def _solve_fn(self, data, lin, lam, carry=None):
        """One solve with a fresh preconditioner: ``(dx, stats)``."""
        minv = self.build_precond(data, lin, lam)
        return self.cg(data, lin, lam, minv, carry)

    def _solve_state_fn(self, data, lin, lam, state):
        """The stateful protocol of the LM loops:
        ``(dx, state', stats)``; the state is the carried residual floor
        when ``absolute_tolerance`` is on, else passed through."""
        carry = state if self.absolute_tolerance else None
        dx, st = self._solve_fn(data, lin, lam, carry)
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
        return self._solve_fn(data, lin, lam)[0]
