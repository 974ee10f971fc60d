"""Compiled structure-of-arrays problem, batched linearization and H·v —
port of the non-bucketed paths of ``g2o_tpu/core/problem.py``.

* residuals: one call of an edge type's residual on ``(E, ·)`` tensors;
* Jacobians: exact autodiff through each vertex type's ``oplus`` at zero
  perturbation, with ``torch.func``: reverse mode (one ``vjp``, then the
  ``r`` cotangent rows under ``vmap``) when the residual is shorter than
  the total perturbation (SE3 pose graph: 6 < 12), forward mode
  otherwise.  Edges are independent, so a cotangent row applied to the
  whole batch yields that row of every edge's Jacobian;
* the gradient ``b`` and the per-vertex diagonal blocks of ``H`` are
  accumulated with ``index_add_``; ``H`` itself is never formed: PCG uses
  :meth:`Problem.hvp_operator` (gather, ``WJ·v``, ``Jcatᵀz``, ``index_add_``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jvp, vjp, vmap

from g2o_tpu_torch.core.types import REGISTRY, EdgeType
from g2o_tpu_torch.ops import robust as robust_mod


class EdgeBatchData(NamedTuple):
    """Tensors of one edge-type batch."""

    vidx: torch.Tensor     # (E, k) int64 — per-slot index into that slot's vertex type
    meas: torch.Tensor     # (E, m)
    info: torch.Tensor     # (E, r, r)
    kernel: torch.Tensor   # (E,) int64 robust-kernel id
    delta: torch.Tensor    # (E,) robust-kernel width
    active: torch.Tensor   # (E,) bool — the fork's per-edge isActive flag
    param: torch.Tensor    # (E, p)


class ProblemData(NamedTuple):
    """Non-estimate tensors of a compiled problem."""

    edges: dict            # edge name -> EdgeBatchData
    fixed: dict            # vertex-type name -> (N_t,) bool
    free_mask: dict        # edge name -> (E, k): 0.0 where the slot's vertex is fixed


class LinearizedSystem(NamedTuple):
    """Output of one linearization — everything the iterative solvers need."""

    jacs: dict             # edge name -> tuple of (E, r, d_s), fixed slots zeroed
    weights: dict          # edge name -> (E, r, r) = rho' * active * Omega
    errors: dict           # edge name -> (E, r)
    b: torch.Tensor        # (T,) = -Jᵀ W e   (solve H dx = b)
    diag: dict             # vertex-type name -> (N_t, d, d) Hessian diagonal blocks
    chi2_robust: torch.Tensor
    chi2: torch.Tensor


class Problem:
    """Compiled problem.  Estimates are a ``{type name: (N_t, rep)}`` dict."""

    def __init__(self, vertex_types, counts, edge_types, data: ProblemData,
                 estimates: dict, vid_index: dict, type_bases: dict,
                 total_dim: int, dtype, device, uniform_kernel=None,
                 assembly_precision: str = "highest", n_active_edges=None):
        # accepted for API parity with the JAX package: the port assembles
        # in full precision either way (TF32 is off package-wide)
        if assembly_precision not in ("highest", "default"):
            raise ValueError(
                f"unknown assembly_precision {assembly_precision!r}")
        self.assembly_precision = assembly_precision
        self.vertex_types = vertex_types
        self.counts = counts
        self.edge_types = edge_types
        self.data = data
        self.estimates = estimates
        self.vid_index = vid_index          # vid -> (type name, local index)
        self.type_bases = type_bases        # type name -> flat tangent base offset
        self.total_dim = int(total_dim)
        self.dtype = dtype
        self.device = torch.device(device)
        # edge name -> static kernel id when the whole batch shares one
        # kernel (one kernel evaluated instead of all ten and a select)
        self.uniform_kernel = uniform_kernel or {}
        self.n_active_edges = n_active_edges

    # ------------------------------------------------------------------ #
    # host-side helpers
    # ------------------------------------------------------------------ #

    @property
    def num_edges(self):
        if self.n_active_edges is not None:
            return self.n_active_edges
        return sum(int(b.vidx.shape[0]) for b in self.data.edges.values())

    def set_estimates(self, estimates):
        self.estimates = estimates

    def estimates_by_vid(self):
        host = {t: e.cpu().numpy() for t, e in self.estimates.items()}
        return {vid: host[t][i] for vid, (t, i) in self.vid_index.items()}

    # ------------------------------------------------------------------ #
    # per-edge residuals and Jacobians
    # ------------------------------------------------------------------ #

    def _states(self, et: EdgeType, batch: EdgeBatchData, estimates):
        return tuple(estimates[vt.name][batch.vidx[:, s]]
                     for s, vt in enumerate(et.vertex_types))

    def _residuals(self, et, batch, estimates):
        return et.residual(self._states(et, batch, estimates), batch.meas,
                           batch.param)

    def _residuals_and_jacobians(self, et: EdgeType, batch: EdgeBatchData,
                                 estimates):
        """``e (E, r)`` at the current states and the slot Jacobians
        ``(E, r, d_s)`` of ``e(x ⊞ δ)`` at ``δ = 0``.  The error is evaluated
        at the states themselves, not at ``x ⊞ 0``: ``oplus`` renormalizes a
        quaternion that is unit only to the precision it was read with."""
        vts = tuple(et.vertex_types)
        states = self._states(et, batch, estimates)
        e = et.residual(states, batch.meas, batch.param)
        E = batch.vidx.shape[0]
        r = et.residual_dim
        zeros = tuple(torch.zeros((E, vt.tangent_dim), dtype=self.dtype,
                                  device=self.device) for vt in vts)

        def f(*deltas):
            news = tuple(vt.oplus(x, d) for vt, x, d in zip(vts, states, deltas))
            return et.residual(news, batch.meas, batch.param)

        if r < sum(vt.tangent_dim for vt in vts):
            _, pull = vjp(f, *zeros)
            basis = torch.eye(r, dtype=e.dtype, device=e.device)[:, None, :]
            rows = vmap(pull)(basis.expand(r, E, r))    # per slot (r, E, d_s)
            return e, tuple(R.permute(1, 0, 2) for R in rows)
        Js = []
        for s, vt in enumerate(vts):
            def push(t, s=s):
                tangents = tuple(t if j == s else z for j, z in enumerate(zeros))
                return jvp(f, zeros, tangents)[1]
            d = vt.tangent_dim
            basis = torch.eye(d, dtype=e.dtype, device=e.device)[:, None, :]
            Js.append(vmap(push)(basis.expand(d, E, d)).permute(1, 2, 0))
        return e, tuple(Js)

    def _robustify(self, name, batch, e2):
        uk = self.uniform_kernel.get(name)
        if uk is not None:
            return robust_mod.robustify(uk, e2, batch.delta)
        return robust_mod.robustify_batch(batch.kernel, e2, batch.delta)

    def edge_jacs(self, lin, name):
        """Row-major ``(E, r, d_s)`` Jacobian slot tuple of batch ``name``."""
        return lin.jacs[name]

    def edge_weights(self, lin, name):
        """Row-major ``(E, r, r)`` robust information of batch ``name``."""
        return lin.weights[name]

    # ------------------------------------------------------------------ #
    # tangent-vector layout
    # ------------------------------------------------------------------ #

    def split_tangent(self, v):
        """Flat ``(T,)`` tangent vector -> ``{type: (N_t, d_t)}`` views."""
        return {t: v[self.type_bases[t]:self.type_bases[t]
                     + self.counts[t] * vt.tangent_dim].reshape(
                         self.counts[t], vt.tangent_dim)
                for t, vt in self.vertex_types.items()}

    def join_tangent(self, blocks):
        """Inverse of :meth:`split_tangent`."""
        return torch.cat([blocks[t].reshape(-1) for t in self.vertex_types])

    def tree_dot(self, a, b):
        """Dot product over block-layout tangent vectors (a 0-d tensor)."""
        return sum(torch.sum(a[t] * b[t]) for t in self.vertex_types)

    # ------------------------------------------------------------------ #
    # chi2, linearization, H·v, update
    # ------------------------------------------------------------------ #

    def chi2_fn(self, data: ProblemData, estimates):
        """(robust chi2, plain chi2) — reference ``activeRobustChi2`` /
        ``activeChi2`` (``g2o/core/sparse_optimizer.cpp:94-116``)."""
        total_r = torch.zeros((), dtype=self.dtype, device=self.device)
        total_p = torch.zeros((), dtype=self.dtype, device=self.device)
        for name, et in self.edge_types.items():
            batch = data.edges[name]
            e = self._residuals(et, batch, estimates)
            e2 = torch.einsum("er,ers,es->e", e, batch.info, e)
            rho = self._robustify(name, batch, e2)
            act = batch.active.to(self.dtype)
            total_r = total_r + torch.sum(rho[:, 0] * act)
            total_p = total_p + torch.sum(e2 * act)
        return total_r, total_p

    def linearize_fn(self, data: ProblemData, estimates) -> LinearizedSystem:
        b_blocks = {t: torch.zeros((self.counts[t], vt.tangent_dim),
                                   dtype=self.dtype, device=self.device)
                    for t, vt in self.vertex_types.items()}
        diag = {t: torch.zeros((self.counts[t], vt.tangent_dim, vt.tangent_dim),
                               dtype=self.dtype, device=self.device)
                for t, vt in self.vertex_types.items()}
        jacs, weights, errors = {}, {}, {}
        chi2_r = torch.zeros((), dtype=self.dtype, device=self.device)
        chi2_p = torch.zeros((), dtype=self.dtype, device=self.device)
        for name, et in self.edge_types.items():
            batch = data.edges[name]
            e, Js = self._residuals_and_jacobians(et, batch, estimates)
            # zero Jacobian columns of fixed vertices — the masking
            # analogue of hessianIndex == -1 (sparse_optimizer.cpp:179-188)
            fm = data.free_mask[name]
            Js = tuple(J * fm[:, s, None, None] for s, J in enumerate(Js))
            e2 = torch.einsum("er,ers,es->e", e, batch.info, e)
            rho = self._robustify(name, batch, e2)
            act = batch.active.to(self.dtype)
            chi2_r = chi2_r + torch.sum(rho[:, 0] * act)
            chi2_p = chi2_p + torch.sum(e2 * act)
            # robust information rho' * Omega (BaseEdge::robustInformation;
            # the rho'' term is disabled there as well), inactive rows zero
            W = batch.info * (rho[:, 1] * act)[:, None, None]
            We = torch.einsum("ers,es->er", W, e)
            for s, (J, vt) in enumerate(zip(Js, et.vertex_types)):
                t = vt.name
                brows = -torch.einsum("erd,er->ed", J, We)
                Hss = torch.einsum("erd,ers,esf->edf", J, W, J)
                b_blocks[t].index_add_(0, batch.vidx[:, s], brows)
                diag[t].index_add_(0, batch.vidx[:, s], Hss)
            jacs[name], weights[name], errors[name] = Js, W, e
        return LinearizedSystem(jacs, weights, errors,
                                self.join_tangent(b_blocks), diag, chi2_r,
                                chi2_p)

    def hvp_operator(self, data: ProblemData, lin: LinearizedSystem):
        """The ``H·v`` closure for CG loops, in block layout.

        Precomputed once per linearization: the slot-concatenated Jacobian
        ``Jcat (E, r, K)`` and ``WJ = W·Jcat``.  Each application is, per
        edge type, one row gather, ``z = WJ·v_rows``, ``Jcatᵀz`` and one
        ``index_add_`` per vertex type."""
        pre = {}
        for name in self.edge_types:
            Jcat = torch.cat(self.edge_jacs(lin, name), dim=2)   # (E, r, K)
            WJ = torch.einsum("ers,esk->erk", self.edge_weights(lin, name),
                              Jcat)
            pre[name] = (Jcat, WJ)

        def hvp(vb):
            out = {t: torch.zeros_like(vb[t]) for t in self.vertex_types}
            for name, et in self.edge_types.items():
                vidx = data.edges[name].vidx
                Jcat, WJ = pre[name]
                rows = torch.cat([vb[vt.name][vidx[:, s]]
                                  for s, vt in enumerate(et.vertex_types)],
                                 dim=1)                           # (E, K)
                z = torch.einsum("erk,ek->er", WJ, rows)
                contrib = torch.einsum("erk,er->ek", Jcat, z)
                off = 0
                for s, vt in enumerate(et.vertex_types):
                    d = vt.tangent_dim
                    out[vt.name].index_add_(0, vidx[:, s],
                                            contrib[:, off:off + d])
                    off += d
            return out

        return hvp

    def apply_update_fn(self, data: ProblemData, estimates, dx):
        """x ⊞ dx per vertex type, fixed vertices pinned — reference
        ``SparseOptimizer::update`` (``g2o/core/sparse_optimizer.cpp:441``)."""
        blocks = self.split_tangent(dx)
        out = {}
        for t, vt in self.vertex_types.items():
            free = 1.0 - data.fixed[t].to(self.dtype)
            out[t] = vt.oplus(estimates[t], blocks[t] * free[:, None])
        return out


# --------------------------------------------------------------------------- #
# compilation
# --------------------------------------------------------------------------- #

_EDGE_FIELDS = EdgeBatchData._fields


def _resolve(types, name):
    try:
        return types[name]
    except KeyError:
        raise ValueError(f"unregistered type {name!r}") from None


def _make_problem(vertex_arrays, edge_arrays, *, vid_index, dtype, device,
                  pad_edges_to_multiple=1, assembly_precision="highest",
                  registry=None):
    """Shared tail of :func:`build_problem` and :func:`problem_from_numpy`:
    ``vertex_arrays`` is ``{type name: (estimates (N, rep), fixed (N,))}``
    in internal vertex order, ``edge_arrays`` is ``{edge name: {field:
    array}}`` with LOCAL vertex indices in ``vidx``."""
    registry = registry or REGISTRY
    dtype = torch.float64 if dtype is None else dtype
    device = torch.device(device)
    vertex_types, counts, type_bases, estimates, fixed, fixed_np = \
        {}, {}, {}, {}, {}, {}
    base = 0
    for t, (est, fx) in vertex_arrays.items():
        vt = _resolve(registry.vertex_types, t)
        est = np.asarray(est, dtype=np.float64).reshape(-1, vt.rep_dim)
        fx = np.asarray(fx, dtype=bool).reshape(-1)
        vertex_types[t] = vt
        counts[t] = est.shape[0]
        type_bases[t] = base
        base += counts[t] * vt.tangent_dim
        estimates[t] = torch.tensor(est, dtype=dtype, device=device)
        fixed[t] = torch.tensor(fx, device=device)
        fixed_np[t] = fx

    m = max(int(pad_edges_to_multiple), 1)
    edge_types, edges, free_mask, uniform_kernel = {}, {}, {}, {}
    n_active = 0
    for name, arrays in edge_arrays.items():
        et = _resolve(registry.edge_types, name)
        edge_types[name] = et
        a = {k: np.asarray(arrays[k]) for k in _EDGE_FIELDS}
        E = a["vidx"].shape[0]
        a["active"] = a["active"].astype(bool)
        n_active += int(a["active"].sum())
        if a["param"].ndim != 2 or a["param"].shape[1] != et.param_dim:
            raise ValueError(f"{name}: parameter values have shape "
                             f"{a['param'].shape}, expected (E, "
                             f"{et.param_dim})")
        if E:
            uks = np.unique(a["kernel"])
            uniform_kernel[name] = int(uks[0]) if len(uks) == 1 else None
        # pad by replicating row 0 as inactive rows (W == 0 kills them)
        n_pad = (-E) % m if E else 0
        if n_pad:
            a = {k: np.concatenate([v, np.repeat(v[:1], n_pad, axis=0)])
                 for k, v in a.items()}
            a["active"][E:] = False
        vidx = a["vidx"].astype(np.int64)
        fm = np.stack([1.0 - fixed_np[vt.name][vidx[:, s]]
                       for s, vt in enumerate(et.vertex_types)], axis=1)
        free_mask[name] = torch.as_tensor(fm, dtype=dtype, device=device)

        def ten(x, dt=dtype):
            return torch.tensor(x, dtype=dt, device=device)

        edges[name] = EdgeBatchData(
            vidx=ten(vidx, torch.int64),
            meas=ten(a["meas"]),
            info=ten(a["info"]),
            kernel=ten(a["kernel"], torch.int64),
            delta=ten(a["delta"]),
            active=ten(a["active"], torch.bool),
            param=ten(a["param"]),
        )
    data = ProblemData(edges=edges, fixed=fixed, free_mask=free_mask)
    return Problem(vertex_types, counts, edge_types, data, estimates,
                   vid_index, type_bases, base, dtype, device,
                   uniform_kernel=uniform_kernel,
                   assembly_precision=assembly_precision,
                   n_active_edges=n_active)


def build_problem(vertex_blocks, edge_blocks, *, dtype=None, device="cpu",
                  pad_edges_to_multiple: int = 1,
                  assembly_precision: str = "highest",
                  registry=None) -> Problem:
    """Build a :class:`Problem` from raw numpy blocks keyed by type name:

    ``vertex_blocks``: ``{name: (vids (N,), estimates (N, rep), fixed (N,))}``;
    ``edge_blocks``: ``{name: (vids (E, k) raw ids, meas (E, m), info (E, r, r),
    kernel (E,), delta (E,), active (E,), param (E, p))}``.

    Vertices are sorted by id within each type — the deterministic index
    mapping of the reference (``sparse_optimizer.cpp:168,504``) and of the
    JAX package, so both give the same tangent layout."""
    vertex_arrays, sorted_vids, vid_index = {}, {}, {}
    for t, (vids, est, fx) in vertex_blocks.items():
        order = np.argsort(np.asarray(vids), kind="stable")
        sv = np.asarray(vids, dtype=np.int64)[order]
        vertex_arrays[t] = (np.asarray(est, dtype=np.float64)[order],
                            np.asarray(fx, dtype=bool)[order])
        sorted_vids[t] = sv
        vid_index.update(zip(sv.tolist(), ((t, i) for i in range(len(sv)))))
    registry = registry or REGISTRY
    edge_arrays = {}
    for name, (vids, meas, info, kern, delt, act, par) in edge_blocks.items():
        et = _resolve(registry.edge_types, name)
        raw = np.asarray(vids, dtype=np.int64).reshape(-1, et.num_slots)
        vidx = np.empty_like(raw)
        for s, svt in enumerate(et.vertex_types):
            sv = sorted_vids.get(svt.name)
            if sv is None:
                raise ValueError(f"{name}: no vertices of type {svt.name} "
                                 f"present")
            loc = np.searchsorted(sv, raw[:, s])
            bad = (loc >= len(sv)) | (sv[np.minimum(loc, len(sv) - 1)]
                                      != raw[:, s])
            if bad.any():
                raise ValueError(f"{name}: unknown vertex id "
                                 f"{int(raw[:, s][bad][0])}")
            vidx[:, s] = loc
        edge_arrays[name] = dict(vidx=vidx, meas=meas, info=info,
                                 kernel=kern, delta=delt, active=act,
                                 param=par)
    return _make_problem(vertex_arrays, edge_arrays, vid_index=vid_index,
                         dtype=dtype, device=device,
                         pad_edges_to_multiple=pad_edges_to_multiple,
                         assembly_precision=assembly_precision,
                         registry=registry)


def problem_from_numpy(vertices, edges, *, dtype=None, device="cpu",
                       vid_index=None, registry=None) -> Problem:
    """A :class:`Problem` from arrays that are already in compiled form —
    e.g. a JAX ``Problem``'s ``p.estimates[t]``, ``p.data.fixed[t]`` and
    ``p.data.edges[name]`` turned to numpy — so both packages optimize
    exactly the same arrays.

    ``vertices``: ``{type name: (estimates (N, rep), fixed (N,))}`` in the
    tangent layout order; ``edges``: ``{edge name: {vidx, meas, info,
    kernel, delta, active, param}}`` with local vertex indices."""
    return _make_problem(vertices, edges, vid_index=vid_index or {},
                         dtype=dtype, device=device, registry=registry)


def compile_graph(graph, *, dtype=None, device="cpu", level: int = 0,
                  pad_edges_to_multiple: int = 1,
                  assembly_precision: str = "highest") -> Problem:
    """Freeze a host :class:`~g2o_tpu_torch.core.graph.Graph` — the analogue
    of ``initializeOptimization`` + ``buildIndexMapping``
    (``g2o/core/sparse_optimizer.cpp:201,168``)."""
    by_type: dict[str, list] = {}
    for rec in graph.vertices().values():
        by_type.setdefault(rec.vtype.name, []).append(rec)
    vertex_blocks = {
        t: (np.array([r.vid for r in recs], dtype=np.int64),
            np.stack([r.estimate for r in recs]),
            np.array([r.fixed for r in recs], dtype=bool))
        for t, recs in by_type.items()}

    erecs: dict[str, list] = {}
    for e in graph.edges():
        if e.level == level:
            erecs.setdefault(e.etype.name, []).append(e)
    edge_blocks = {}
    for name, recs in erecs.items():
        et = recs[0].etype
        if et.param_dim:
            par = np.stack([np.concatenate([graph.parameter(pid)
                                            for pid in e.param_id])
                            for e in recs])
        else:
            par = np.zeros((len(recs), 0))
        edge_blocks[name] = (
            np.array([e.vids for e in recs], dtype=np.int64),
            np.stack([e.measurement for e in recs]),
            np.stack([e.information for e in recs]),
            np.array([e.kernel for e in recs], dtype=np.int64),
            np.array([e.delta for e in recs], dtype=np.float64),
            np.array([e.active for e in recs], dtype=bool),
            par,
        )
    return build_problem(vertex_blocks, edge_blocks, dtype=dtype,
                         device=device,
                         pad_edges_to_multiple=pad_edges_to_multiple,
                         assembly_precision=assembly_precision,
                         registry=graph.registry)
