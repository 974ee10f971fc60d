"""Compiled structure-of-arrays problem, batched linearization and H·v —
port of ``g2o_tpu/core/problem.py``.

* residuals: one call of an edge type's residual on ``(E, ·)`` tensors;
* Jacobians: exact autodiff through each vertex type's ``oplus`` at zero
  perturbation, with ``torch.func``: reverse mode (one ``vjp``, then the
  ``r`` cotangent rows under ``vmap``) when the residual is shorter than
  the total perturbation (SE3 pose graph: 6 < 12), forward mode
  otherwise.  Edges are independent, so a cotangent row applied to the
  whole batch yields that row of every edge's Jacobian;
* the gradient ``b`` and the per-vertex diagonal blocks of ``H`` are
  accumulated with ``index_add_``; PCG never forms ``H``: it uses
  :meth:`Problem.hvp_operator` (gather, ``WJ·v``, ``Jcatᵀz``, ``index_add_``).
  The dense solver assembles it with :meth:`Problem.dense_hessian_fn`.

Sharded data (:func:`g2o_tpu_torch.parallel.shard_problem_data`): every
edge batch holds one contiguous slice of its rows on each process of a
``torch.distributed`` group (``ProblemData.group``); estimates and
everything per vertex stay replicated.  Each sum over edges into a
replicated result is completed by :func:`edge_sum_` (one
``all_reduce(SUM)``), so every process ends with the same numbers; with no
group, or a group of one, the code is the unsharded code.

``state_dtype`` wider than ``dtype`` (mixed precision): estimates,
measurements, information and parameters are stored wide, and the whole
linearization, chi2 and ``oplus`` run at ``state_dtype``; the
:class:`LinearizedSystem` leaves the solvers see are rounded to ``dtype``
once, at the end.  Rounding the wide-assembled ``b`` is a relative error,
so the Gauss-Newton fixed point is the wide one; assembling ``b`` narrow
leaves an absolute summation noise that floors the fixed point above it.

``bucket_landmarks=True`` lays bundle adjustment out for the implicit
Schur solver (``g2o_tpu_torch/ops/bucketed.py``): the landmarks of a type
observed by one edge type are reordered into bucket order, the observation
rows into degree-bucketed slabs.  Such a batch reads its camera states
with the (row-major) gather kernel and is linearized DIMS-MAJOR (edge axis
last): its landmark sums are per-slab reshapes, its camera ``b`` and
diagonal blocks come from the segment-sum kernel (``ops/onehot.py``), and the
linearization hands the solver the off-diagonal blocks and the
bucket-order landmark system in ``LinearizedSystem.extras``.

The entry points build on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.func import jvp, vjp, vmap

from g2o_tpu_torch.core.types import REGISTRY, EdgeType
from g2o_tpu_torch.ops import robust as robust_mod
from g2o_tpu_torch.ops.bucketed import bucket_by_segment, slab_sum_t
from g2o_tpu_torch.ops.onehot import onehot_gather, onehot_scatter_add_t
from g2o_tpu_torch.utils.tictoc import span


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
    offsets: dict          # vertex-type name -> (N_t,) int64 flat tangent offset
    fixed_flat: torch.Tensor  # (T,) 1.0 on the tangent slots of fixed vertices
    # bucketed edge name -> {"segp": (S_used,) int64 bucket-order landmark
    # ids, "ids32": (k, E) int32 slot ids for the kernels, "meas_t" (m, E),
    # "info_t" (r, r, E), "free_mask" (E, k), "free_mask_t" (k, E)}
    plans: dict = {}
    # the torch.distributed group the edge rows are sharded over (each
    # process holds rows [rank·n, (rank+1)·n) of every batch); None: every
    # row is here
    group: object = None


# the edge-axis of each per-edge plan tensor (the others are per vertex)
PLAN_EDGE_AXIS = {"ids32": -1, "meas_t": -1, "info_t": -1, "free_mask": 0,
                  "free_mask_t": -1}

# all-reduces of edge sums in this process: calls, bytes, host seconds
REDUCE_STATS = {"calls": 0, "bytes": 0, "seconds": 0.0}


def shard_rank(data):
    """``(rank, world)`` of this process in ``data``'s shard group;
    ``(0, 1)`` for unsharded data."""
    if data.group is None:
        return 0, 1
    return dist.get_rank(data.group), dist.get_world_size(data.group)


def row_window(data, name):
    """``(lo, n)``: this process holds rows ``[lo, lo + n)`` of edge batch
    ``name``."""
    n = int(data.edges[name].vidx.shape[0])
    return shard_rank(data)[0] * n, n


def edge_sum_(data, *tensors):
    """Complete sums over the edge rows of sharded data, in place: one
    ``all_reduce(SUM)`` over ``data.group`` for all ``tensors`` of one
    dtype.  A no-op for unsharded data."""
    all_reduce_sum_(data.group, *tensors)


def all_reduce_sum_(group, *tensors):
    """In place, one ``all_reduce(SUM)`` over ``group`` for all ``tensors``
    of one dtype (concatenated); a no-op when ``group`` is None."""
    if group is None or not tensors:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        buf = (ts[0].reshape(-1).clone() if len(ts) == 1
               else torch.cat([t.reshape(-1) for t in ts]))
        t0 = time.perf_counter()
        dist.all_reduce(buf, group=group)
        REDUCE_STATS["seconds"] += time.perf_counter() - t0
        REDUCE_STATS["calls"] += 1
        REDUCE_STATS["bytes"] += buf.numel() * buf.element_size()
        off = 0
        for t in ts:
            t.copy_(buf[off:off + t.numel()].view(t.shape))
            off += t.numel()


def replicated_part(data, x):
    """A copy of ``x`` on the first process of ``data``'s group, zeros on
    the others: a replicated term added into a sum before :func:`edge_sum_`
    counts once.  ``x`` itself for unsharded data."""
    if data.group is None:
        return x
    return x.clone() if shard_rank(data)[0] == 0 else torch.zeros_like(x)


def full_rows(data, x, axis=0):
    """The rows of every process of ``data``'s group, in order, along
    ``axis`` (the unsharded batch): this process's rows written into a
    zeroed full buffer, summed over the group.  ``x`` for unsharded
    data."""
    rank, world = shard_rank(data)
    if data.group is None:
        return x
    axis = axis % x.dim()
    n = x.shape[axis]
    shape = list(x.shape)
    shape[axis] = n * world
    out = x.new_zeros(shape)
    out.narrow(axis, rank * n, n).copy_(x)
    edge_sum_(data, out)
    return out


class BucketedEdgeSpec(NamedTuple):
    """Static shape facts of a landmark-bucketed edge batch (its index
    tensors travel in ``ProblemData.plans``).  Rows ``[0, n_rows)`` form
    ``len(degrees)`` slabs: slab ``b`` holds ``counts[b]`` landmarks ×
    ``degrees[b]`` padded rows, degree-major; padding rows replicate their
    landmark's first row with ``active=False`` (W == 0)."""

    pose_slot: int
    lm_slot: int
    counts: tuple
    degrees: tuple
    n_rows: int          # sum(counts[b] * degrees[b]) — slab-covered prefix
    # True when the landmark type's vertex order IS the bucket segment
    # order (build_problem reorders it when one edge type buckets the
    # type): segp == arange, so segment gathers and scatters are slices
    seg_identity: bool = False


class LinearizedSystem(NamedTuple):
    """Output of one linearization — everything the iterative solvers need."""

    jacs: dict             # edge name -> tuple of (E, r, d_s), fixed slots
    # zeroed; BUCKETED batches store DIMS-MAJOR (r, d_s, E) leaves (use
    # Problem.edge_jacs for the row-major view)
    weights: dict          # edge name -> (E, r, r) = rho' * active * Omega
    # (bucketed: (r, r, E); Problem.edge_weights)
    errors: dict           # edge name -> (E, r)  (bucketed: (r, E))
    b: torch.Tensor        # (T,) = -Jᵀ W e   (solve H dx = b)
    diag: dict             # vertex-type name -> (N_t, d, d) Hessian diagonal blocks
    chi2_robust: torch.Tensor
    chi2: torch.Tensor
    # bucketed edge name -> {"Bt": (dp, dl, E) off-diagonal blocks JpᵀWJl,
    # "bl_bucket(_t)", "Hll_bucket(_t)": the landmark gradient rows and
    # diagonal blocks in BUCKET order, row-major and dims-major}; the
    # implicit Schur solver reads them instead of re-deriving them per
    # λ-trial
    extras: dict = {}


class Problem:
    """Compiled problem.  Estimates are a ``{type name: (N_t, rep)}`` dict;
    ``marginalized`` is a host-side ``{type name: (N_t,) bool}`` numpy dict
    (the vertices a Schur solver eliminates)."""

    def __init__(self, vertex_types, counts, edge_types, data: ProblemData,
                 estimates: dict, marginalized: dict, vid_index: dict,
                 type_bases: dict, total_dim: int, dtype, device,
                 uniform_kernel=None, assembly_precision: str = "highest",
                 n_active_edges=None, bucket_specs=None, state_dtype=None):
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
        self.marginalized = marginalized
        self.vid_index = vid_index          # vid -> (type name, local index)
        self.type_bases = type_bases        # type name -> flat tangent base offset
        self.total_dim = int(total_dim)
        self.dtype = dtype
        # the dtype of the estimates and of the whole linearization; the
        # solvers see its results rounded to ``dtype`` (module docstring)
        self.state_dtype = dtype if state_dtype is None else state_dtype
        self.device = torch.device(device)
        # edge name -> static kernel id when the whole batch shares one
        # kernel (one kernel evaluated instead of all ten and a select)
        self.uniform_kernel = uniform_kernel or {}
        self.n_active_edges = n_active_edges
        # edge name -> BucketedEdgeSpec of the landmark-bucketed batches
        self.bucket_specs = bucket_specs or {}

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

    def get_estimate(self, vid):
        """The estimate of vertex ``vid`` as a host numpy array."""
        t, i = self.vid_index[vid]
        return self.estimates[t][i].cpu().numpy()

    def gauge_freedom(self) -> bool:
        """True when no vertex is fixed (reference ``gaugeFreedom``,
        ``g2o/core/sparse_optimizer.cpp:139``)."""
        return not any(bool(f.any()) for f in self.data.fixed.values())

    # ------------------------------------------------------------------ #
    # per-edge residuals and Jacobians
    # ------------------------------------------------------------------ #

    def _slab_rows(self, est, name, plans, n_rows, lo=0):
        """The landmark states of rows ``[lo, lo + n_rows)`` of bucketed
        batch ``name`` ``(n_rows, rep)``: one bucket-order read of the
        landmark estimates and a broadcast per slab (every row of a slab
        segment, its padding included, is that segment's landmark).  Rows
        past the slab-covered prefix (``pad_edges_to_multiple``) repeat
        batch row 0, the first segment's first row."""
        spec = self.bucket_specs[name]
        n_used = sum(spec.counts)
        est_used = (est[:n_used] if spec.seg_identity
                    else est[plans[name]["segp"]])
        rows, off = [], 0
        for nseg, dg in zip(spec.counts, spec.degrees):
            v = est_used[off:off + nseg]
            rows.append(v[None].expand(dg, nseg, v.shape[1]).reshape(
                nseg * dg, v.shape[1]))
            off += nseg
        tail = lo + n_rows - spec.n_rows
        if tail > 0:
            rows.append(est_used[:1].expand(tail, est_used.shape[1]))
        return torch.cat(rows, dim=0)[lo:lo + n_rows]

    def _states(self, et: EdgeType, batch: EdgeBatchData, estimates,
                name=None, plans=None, lo=0):
        """Per-edge vertex states, row-major ``(E, rep)`` per slot.  A
        bucketed batch reads its landmarks per slab and gathers its cameras
        with the gather kernel — the same rows as the plain row gather;
        ``lo`` is the batch's first row on this process (sharded data)."""
        spec = self.bucket_specs.get(name) if plans is not None else None
        states = []
        for s, vt in enumerate(et.vertex_types):
            t = vt.name
            if spec is not None and s == spec.lm_slot:
                states.append(self._slab_rows(estimates[t], name, plans,
                                              batch.vidx.shape[0], lo))
            elif spec is not None and s == spec.pose_slot:
                states.append(onehot_gather(plans[name]["ids32"][s],
                                            estimates[t]))
            else:
                states.append(estimates[t][batch.vidx[:, s]])
        return tuple(states)

    def _robustify(self, name, batch, e2):
        uk = self.uniform_kernel.get(name)
        if uk is not None:
            return robust_mod.robustify(uk, e2, batch.delta)
        return robust_mod.robustify_batch(batch.kernel, e2, batch.delta)

    # layout accessors: bucketed batches keep DIMS-MAJOR leaves in the
    # LinearizedSystem; these give the row-major views every other
    # consumer (H·v, the dense and explicit Schur solvers) works in

    def edge_jacs(self, lin, name):
        """Row-major ``(E, r, d_s)`` Jacobian slot tuple of batch ``name``."""
        if name in self.bucket_specs:
            return tuple(J.permute(2, 0, 1) for J in lin.jacs[name])
        return lin.jacs[name]

    def edge_weights(self, lin, name):
        """Row-major ``(E, r, r)`` robust information of batch ``name``."""
        W = lin.weights[name]
        return W.permute(2, 0, 1) if name in self.bucket_specs else W

    def edge_errors(self, lin, name):
        """Row-major ``(E, r)`` residuals of batch ``name``."""
        e = lin.errors[name]
        return e.T if name in self.bucket_specs else e

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
        sdt = self.state_dtype
        total_r = torch.zeros((), dtype=sdt, device=self.device)
        total_p = torch.zeros((), dtype=sdt, device=self.device)
        for name, et in self.edge_types.items():
            batch = data.edges[name]
            e = et.residual(self._states(et, batch, estimates, name,
                                         data.plans,
                                         row_window(data, name)[0]),
                            batch.meas, batch.param)
            e2 = torch.einsum("er,ers,es->e", e, batch.info, e)
            rho = self._robustify(name, batch, e2)
            act = batch.active.to(sdt)
            total_r = total_r + torch.sum(rho[:, 0] * act)
            total_p = total_p + torch.sum(e2 * act)
        if data.group is not None:
            tot = torch.stack([total_r, total_p])
            edge_sum_(data, tot)
            total_r, total_p = tot[0], tot[1]
        return total_r, total_p

    def edge_chi2_fn(self, data: ProblemData, estimates):
        """Per-edge robust chi2, ``{edge name: (E,)}`` (inactive and padded
        rows zero) — the reference's ``Edge::chi2()`` after
        ``robustifyError``, as tools that rank edges by error use it."""
        out = {}
        for name, et in self.edge_types.items():
            batch = data.edges[name]
            e = et.residual(self._states(et, batch, estimates, name,
                                         data.plans,
                                         row_window(data, name)[0]),
                            batch.meas, batch.param)
            e2 = torch.einsum("er,ers,es->e", e, batch.info, e)
            rho = self._robustify(name, batch, e2)
            out[name] = rho[:, 0] * batch.active.to(self.dtype)
        return out

    def linearize_fn(self, data: ProblemData, estimates) -> LinearizedSystem:
        """Residuals, Jacobians, robust weights, ``b``, the diagonal blocks
        and chi2 at ``estimates``, all at ``state_dtype``; the solver-facing
        leaves are rounded to ``dtype`` once at the end (chi2 stays wide).
        On sharded data one all-reduce completes ``b``, the diagonal blocks,
        chi2 and the bucketed batches' landmark sums."""
        with span("linearize"):
            return self._linearize(data, estimates)

    def _linearize(self, data: ProblemData, estimates) -> LinearizedSystem:
        sdt = self.state_dtype
        b_blocks = {t: torch.zeros((self.counts[t], vt.tangent_dim),
                                   dtype=sdt, device=self.device)
                    for t, vt in self.vertex_types.items()}
        diag = {t: torch.zeros((self.counts[t], vt.tangent_dim, vt.tangent_dim),
                               dtype=sdt, device=self.device)
                for t, vt in self.vertex_types.items()}
        jacs, weights, errors, extras = {}, {}, {}, {}
        chi2_r = torch.zeros((), dtype=sdt, device=self.device)
        chi2_p = torch.zeros((), dtype=sdt, device=self.device)
        for name, et in self.edge_types.items():
            batch = data.edges[name]
            if name in self.bucket_specs:
                Jt, Wt, e_t, c_r, c_p = self._linearize_bucketed(
                    name, et, batch, data, estimates, b_blocks, diag, extras)
                chi2_r, chi2_p = chi2_r + c_r, chi2_p + c_p
                jacs[name], weights[name], errors[name] = Jt, Wt, e_t
                continue
            e, Js = residuals_and_jacobians(
                et, self._states(et, batch, estimates), batch.meas,
                batch.param)
            # zero Jacobian columns of fixed vertices — the masking
            # analogue of hessianIndex == -1 (sparse_optimizer.cpp:179-188)
            fm = data.free_mask[name]
            Js = tuple(J * fm[:, s, None, None] for s, J in enumerate(Js))
            e2 = torch.einsum("er,ers,es->e", e, batch.info, e)
            rho = self._robustify(name, batch, e2)
            act = batch.active.to(sdt)
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
        if data.group is not None:
            chi2 = torch.stack([chi2_r, chi2_p])
            edge_sum_(data, *b_blocks.values(), *diag.values(), chi2,
                      *(ext[k] for ext in extras.values()
                        for k in ("bl_bucket_t", "Hll_bucket_t")))
            chi2_r, chi2_p = chi2[0], chi2[1]
            for ext in extras.values():     # the row-major views, anew
                ext["bl_bucket"] = ext["bl_bucket_t"].T
                ext["Hll_bucket"] = ext["Hll_bucket_t"].T.reshape(
                    ext["Hll_bucket"].shape)
        b = self.join_tangent(b_blocks)
        if sdt != self.dtype:
            def narrow(tree):
                if isinstance(tree, torch.Tensor):
                    return tree.to(self.dtype)
                if isinstance(tree, dict):
                    return {k: narrow(v) for k, v in tree.items()}
                return tuple(narrow(v) for v in tree)

            jacs, weights, errors, extras, b, diag = narrow(
                (jacs, weights, errors, extras, b, diag))
        return LinearizedSystem(jacs, weights, errors, b, diag, chi2_r,
                                chi2_p, extras)

    def _linearize_bucketed(self, name, et, batch, data, estimates,
                            b_blocks, diag, extras):
        """The DIMS-MAJOR linearization of bucketed batch ``name`` (edge
        axis last), as the JAX package's bucketed branch of
        ``linearize_fn``.  Adds the batch's gradient rows and diagonal
        blocks into ``b_blocks``/``diag`` in place — landmarks by per-slab
        sums in bucket order, cameras by the segment-sum kernel — fills
        ``extras[name]`` and returns ``(Jt, Wt, e_t, chi2_robust, chi2)``.
        The small contractions are written as broadcast products summed
        over the contracted axis, in the JAX package's order."""
        spec = self.bucket_specs[name]
        plan = data.plans[name]
        lo, n_here = row_window(data, name)
        e, Js = residuals_and_jacobians(
            et, self._states(et, batch, estimates, name, data.plans, lo),
            batch.meas, batch.param)
        fm_t = plan["free_mask_t"]
        Jt = tuple(J.permute(1, 2, 0).contiguous() * fm_t[s]     # (r, d, E)
                   for s, J in enumerate(Js))
        e_t = e.T.contiguous()                                   # (r, E)
        info_t = plan["info_t"]                                  # (r, r, E)
        e2 = torch.sum(e_t[:, None, :] * info_t * e_t[None, :, :],
                       dim=(0, 1))
        rho = self._robustify(name, batch, e2)
        act = batch.active.to(self.state_dtype)
        Wt = info_t * (rho[:, 1] * act)[None, None, :]
        Wet = torch.sum(Wt * e_t[None, :, :], dim=1)             # (r, E)
        nb = spec.n_rows

        def slab_sum(z):
            """(k, E) rows -> (k, S_used) per-landmark sums: a (k, deg, n)
            view of each degree-major slab, summed over deg.  Sharded, this
            process's rows sit in a zeroed (k, n_rows) buffer: its partial
            sums, which the linearization's all-reduce completes."""
            if data.group is not None:
                zf = z.new_zeros((z.shape[0], nb))
                m = max(0, min(n_here, nb - lo))
                zf[:, lo:lo + m] = z[:, :m]
                z = zf
            return slab_sum_t(spec.counts, spec.degrees, z)

        ext = extras.setdefault(name, {})
        WJ_ts = []
        for s, vt in enumerate(et.vertex_types):
            t, d = vt.name, vt.tangent_dim
            # WJ[r,f,e] = Σ_s W[r,s,e] J[s,f,e]
            WJ_t = torch.sum(Wt[:, :, None, :] * Jt[s][None, :, :, :], dim=1)
            WJ_ts.append(WJ_t)
            # Hss[d,f,e] = Σ_r J[r,d,e] WJ[r,f,e]
            Hss_t = torch.sum(Jt[s][:, :, None, :] * WJ_t[:, None, :, :],
                              dim=0).reshape(d * d, -1)          # (dd, E)
            brows_t = -torch.sum(Jt[s] * Wet[:, None, :], dim=0)  # (d, E)
            if s == spec.lm_slot:
                bl_t = slab_sum(brows_t[:, :nb])                 # (d, S_used)
                Hll_t = slab_sum(Hss_t[:, :nb])                  # (dd, S_used)
                bl_bucket, Hll_bucket = bl_t.T, Hll_t.T.reshape(-1, d, d)
                ext.update(bl_bucket=bl_bucket, Hll_bucket=Hll_bucket,
                           bl_bucket_t=bl_t, Hll_bucket_t=Hll_t)
                if spec.seg_identity:
                    ns = bl_bucket.shape[0]
                    b_blocks[t][:ns] += bl_bucket
                    diag[t][:ns] += Hll_bucket
                else:
                    b_blocks[t].index_add_(0, plan["segp"], bl_bucket)
                    diag[t].index_add_(0, plan["segp"], Hll_bucket)
            else:
                idx = plan["ids32"][s]
                b_blocks[t] += onehot_scatter_add_t(
                    idx, brows_t.contiguous(), self.counts[t])
                diag[t] += onehot_scatter_add_t(
                    idx, Hss_t.contiguous(), self.counts[t]).reshape(-1, d, d)
        # off-diagonal B = Jpᵀ W Jl, reusing W·Jl of the landmark slot
        ps, ls = spec.pose_slot, spec.lm_slot
        ext["Bt"] = torch.sum(Jt[ps][:, :, None, :]
                              * WJ_ts[ls][:, None, :, :], dim=0)  # (dp, dl, E)
        return (Jt, Wt, e_t, torch.sum(rho[:, 0] * act),
                torch.sum(e2 * act))

    def hvp_operator(self, data: ProblemData, lin: LinearizedSystem,
                     precision=None):
        """The ``H·v`` closure for CG loops, in block layout.

        Precomputed once per linearization: the slot-concatenated Jacobian
        ``Jcat (E, r, K)`` and ``WJ = W·Jcat``.  Each application is, per
        edge type, one row gather, ``z = WJ·v_rows``, ``Jcatᵀz`` and one
        ``index_add_`` per vertex type.

        ``precision`` (``None``, ``"default"`` or ``"highest"``) is accepted
        for API parity with the JAX package: TF32 is off package-wide, so
        the products are full precision either way."""
        if precision not in (None, "default", "highest"):
            raise ValueError(f"unknown precision {precision!r}")
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
            edge_sum_(data, *out.values())
            return out

        return hvp

    def hvp_fn(self, data: ProblemData, lin: LinearizedSystem, v):
        """Flat ``H·v`` for a ``(T,)`` tangent vector, through
        :meth:`hvp_operator`."""
        return self.join_tangent(
            self.hvp_operator(data, lin)(self.split_tangent(v)))

    def dense_hessian_fn(self, data: ProblemData, lin: LinearizedSystem):
        """The full dense ``(T, T)`` tangent-space Hessian ``Σ JᵀWJ`` (the
        dense solver's system), with a unit diagonal on fixed slots so the
        system stays positive definite with ``dx = 0`` there."""
        T = self.total_dim
        H = torch.zeros(T * T, dtype=self.dtype, device=self.device)
        for name, et in self.edge_types.items():
            vidx = data.edges[name].vidx
            Js = self.edge_jacs(lin, name)
            W = self.edge_weights(lin, name)
            idxs = [data.offsets[vt.name][vidx[:, s]][:, None]
                    + torch.arange(vt.tangent_dim, device=self.device)
                    for s, vt in enumerate(et.vertex_types)]
            for i in range(len(Js)):
                WJi = torch.einsum("ers,erd->esd", W, Js[i])
                for j in range(i, len(Js)):
                    Hij = torch.einsum("esd,esf->edf", WJi, Js[j])
                    # flat indices; index_add_ accumulates duplicates (one
                    # vertex in many edges, or in both slots of one edge)
                    flat = idxs[i][:, :, None] * T + idxs[j][:, None, :]
                    H.index_add_(0, flat.reshape(-1), Hij.reshape(-1))
                    if j != i:
                        flat_t = idxs[j][:, :, None] * T + idxs[i][:, None, :]
                        H.index_add_(0, flat_t.reshape(-1),
                                     Hij.transpose(1, 2).reshape(-1))
        edge_sum_(data, H)
        return H.reshape(T, T) + torch.diag(data.fixed_flat)

    def apply_update_fn(self, data: ProblemData, estimates, dx):
        """x ⊞ dx per vertex type, fixed vertices pinned — reference
        ``SparseOptimizer::update`` (``g2o/core/sparse_optimizer.cpp:441``)."""
        blocks = self.split_tangent(dx)
        sdt = self.state_dtype
        out = {}
        for t, vt in self.vertex_types.items():
            free = 1.0 - data.fixed[t].to(sdt)
            out[t] = vt.oplus(estimates[t], blocks[t].to(sdt) * free[:, None])
        return out


def residuals_and_jacobians(et: EdgeType, states, meas, param):
    """``e (E, r)`` of edge type ``et`` at the per-edge ``states`` (a tuple
    of ``(E, rep)`` tensors, one per slot) and the slot Jacobians
    ``(E, r, d_s)`` of ``e(x ⊞ δ)`` at ``δ = 0``.  The error is evaluated
    at the states themselves, not at ``x ⊞ 0``: ``oplus`` renormalizes a
    quaternion that is unit only to the precision it was read with.
    Reverse mode (one ``vjp``, the ``r`` cotangent rows under ``vmap``)
    when the residual is shorter than the tangent, else forward mode."""
    vts = tuple(et.vertex_types)
    e = et.residual(states, meas, param)
    E = states[0].shape[0]
    r = et.residual_dim
    zeros = tuple(torch.zeros((E, vt.tangent_dim), dtype=e.dtype,
                              device=e.device) for vt in vts)

    def f(*deltas):
        news = tuple(vt.oplus(x, d) for vt, x, d in zip(vts, states, deltas))
        return et.residual(news, meas, param)

    if r < sum(vt.tangent_dim for vt in vts):
        _, pull = vjp(f, *zeros)
        basis = torch.eye(r, dtype=e.dtype, device=e.device)[:, None, :]
        rows = vmap(pull)(basis.expand(r, E, r))        # per slot (r, E, d_s)
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


# --------------------------------------------------------------------------- #
# compilation
# --------------------------------------------------------------------------- #

_EDGE_FIELDS = EdgeBatchData._fields


def _resolve(types, name):
    try:
        return types[name]
    except KeyError:
        raise ValueError(f"unregistered type {name!r}") from None


def _device(device):
    """The device to build on; raises for a CUDA device without a card
    (never moves to the CPU quietly)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device=\"cpu\" to build "
                           "the problem on the CPU")
    return device


def _make_problem(vertex_arrays, edge_arrays, *, vid_index, dtype, device,
                  pad_edges_to_multiple=1, assembly_precision="highest",
                  registry=None, bucket_specs=None, segps=None,
                  static_kernels=True, state_dtype=None):
    """Shared tail of :func:`build_problem` and :func:`problem_from_numpy`:
    ``vertex_arrays`` is ``{type name: (estimates (N, rep), fixed (N,),
    marginalized (N,))}`` in internal vertex order, ``edge_arrays`` is
    ``{edge name: {field: array}}`` with LOCAL vertex indices in ``vidx``.
    ``bucket_specs``/``segps`` (edge name -> spec / bucket-order landmark
    ids) mark the batches already laid out in bucketed slabs.
    ``static_kernels=False`` freezes no uniform robust-kernel id: every
    batch dispatches on its per-row kernel ids.  Estimates, measurements,
    information, robust widths and parameters are stored at
    ``state_dtype``: they are the constants of the wide residual, and
    rounding them to ``dtype`` would move the fixed point as rounding the
    states would."""
    bucket_specs = bucket_specs or {}
    registry = registry or REGISTRY
    dtype = torch.float64 if dtype is None else dtype
    sdt = dtype if state_dtype is None else state_dtype
    device = _device(device)
    vertex_types, counts, type_bases, estimates, fixed, fixed_np = \
        {}, {}, {}, {}, {}, {}
    marginalized, offsets = {}, {}
    fixed_flat = []
    base = 0
    for t, (est, fx, mg) in vertex_arrays.items():
        vt = _resolve(registry.vertex_types, t)
        est = np.asarray(est, dtype=np.float64).reshape(-1, vt.rep_dim)
        fx = np.asarray(fx, dtype=bool).reshape(-1)
        vertex_types[t] = vt
        counts[t] = est.shape[0]
        type_bases[t] = base
        offsets[t] = torch.as_tensor(
            base + np.arange(counts[t], dtype=np.int64) * vt.tangent_dim,
            device=device)
        fixed_flat.append(np.repeat(fx, vt.tangent_dim))
        base += counts[t] * vt.tangent_dim
        estimates[t] = torch.tensor(est, dtype=sdt, device=device)
        fixed[t] = torch.tensor(fx, device=device)
        fixed_np[t] = fx
        marginalized[t] = np.asarray(mg, dtype=bool).reshape(-1).copy()

    m = max(int(pad_edges_to_multiple), 1)
    edge_types, edges, free_mask, uniform_kernel = {}, {}, {}, {}
    plans = {}
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
        if E and static_kernels:
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
            meas=ten(a["meas"], sdt),
            info=ten(a["info"], sdt),
            kernel=ten(a["kernel"], torch.int64),
            delta=ten(a["delta"], sdt),
            active=ten(a["active"], torch.bool),
            param=ten(a["param"], sdt),
        )
        if name in bucket_specs:
            # dims-major constants of the bucketed linearization, and int32
            # slot ids for the gather and segment-sum kernels
            b = edges[name]
            plans[name] = dict(
                segp=ten(segps[name], torch.int64),
                ids32=ten(np.ascontiguousarray(vidx.T), torch.int32),
                meas_t=b.meas.T.contiguous(),
                info_t=b.info.permute(1, 2, 0).contiguous(),
                free_mask=free_mask[name],
                free_mask_t=free_mask[name].T.contiguous())
    data = ProblemData(
        edges=edges, fixed=fixed, free_mask=free_mask, offsets=offsets,
        fixed_flat=torch.as_tensor(
            np.concatenate(fixed_flat) if fixed_flat else np.zeros(0),
            dtype=dtype, device=device),
        plans=plans)
    return Problem(vertex_types, counts, edge_types, data, estimates,
                   marginalized, vid_index, type_bases, base, dtype, device,
                   uniform_kernel=uniform_kernel,
                   assembly_precision=assembly_precision,
                   n_active_edges=n_active, bucket_specs=bucket_specs,
                   state_dtype=sdt)


def _bucket_lm_slot(et, E, vertex_arrays):
    """Slot of the single fully-marginalized endpoint of a bucketable binary
    edge batch, or None."""
    if not (E > 0 and len(et.vertex_types) == 2):
        return None
    marg_slots = [s for s, svt in enumerate(et.vertex_types)
                  if len(vertex_arrays[svt.name][2]) > 0
                  and bool(vertex_arrays[svt.name][2].all())]
    return marg_slots[0] if len(marg_slots) == 1 else None


def _reorder_landmarks(vertex_arrays, sorted_vids, edge_arrays, registry):
    """Pass 2 of the bucketed build: a landmark type bucketed by exactly ONE
    edge type is reordered into bucket-segment order, so pass 3's plan has
    ``segp == arange`` (``seg_identity``).  Permutes the type's vertex
    arrays and ids, and renumbers every edge slot of that type, in place."""
    lm_users: dict = {}
    for name, a in edge_arrays.items():
        et = registry.edge_types[name]
        ls = _bucket_lm_slot(et, len(a["vidx"]), vertex_arrays)
        if ls is not None:
            lm_users.setdefault(et.vertex_types[ls].name, []).append(
                (name, ls))
    for lt, users in lm_users.items():
        if len(users) != 1:
            continue
        name, ls = users[0]
        plan = bucket_by_segment(edge_arrays[name]["vidx"][:, ls],
                                 len(sorted_vids[lt]))
        perm_v = plan.seg_perm_full                # new position -> old idx
        inv = np.empty_like(perm_v)
        inv[perm_v] = np.arange(len(perm_v), dtype=perm_v.dtype)
        vertex_arrays[lt] = tuple(x[perm_v] for x in vertex_arrays[lt])
        sorted_vids[lt] = sorted_vids[lt][perm_v]
        for name2, a2 in edge_arrays.items():
            for s2, svt2 in enumerate(registry.edge_types[name2].vertex_types):
                if svt2.name == lt:
                    a2["vidx"][:, s2] = inv[a2["vidx"][:, s2]]


def _bucket_rows(edge_arrays, vertex_arrays, registry):
    """Pass 3 of the bucketed build: the rows of every binary batch with one
    fully-marginalized slot are permuted into the degree-bucketed slabs of
    ``ops/bucketed.py``, in place.  A padding slot replicates the FIRST ROW
    OF ITS OWN SLAB SEGMENT with ``active=False`` — it then shares its
    landmark, so the per-slab landmark broadcasts equal the row gather, and
    W == 0 keeps it out of every sum.  Returns ``(bucket_specs, segps)``."""
    specs, segps = {}, {}
    for name, a in edge_arrays.items():
        et = registry.edge_types[name]
        E = len(a["vidx"])
        ls = _bucket_lm_slot(et, E, vertex_arrays)
        if ls is None:
            continue
        lt = et.vertex_types[ls].name
        plan = bucket_by_segment(a["vidx"][:, ls], len(vertex_arrays[lt][0]))
        perm = plan.perm_src.copy()
        sentinel = plan.perm_src == E
        off = 0
        for nseg, dg in zip(plan.counts, plan.degrees):
            # degree-major slabs (dg, nseg): a segment's first row is its
            # degree-0 slot
            blk = perm[off:off + nseg * dg].reshape(dg, nseg)
            blk[:] = np.where(blk == E, blk[:1, :], blk)
            off += nseg * dg
        for k in _EDGE_FIELDS:
            a[k] = np.asarray(a[k])[perm]          # fancy index: fresh array
        a["active"] = a["active"].astype(bool)
        a["active"][sentinel] = False
        seg_ident = bool(np.array_equal(
            plan.seg_perm, np.arange(len(plan.seg_perm),
                                     dtype=plan.seg_perm.dtype)))
        specs[name] = BucketedEdgeSpec(
            pose_slot=1 - ls, lm_slot=ls, counts=plan.counts,
            degrees=plan.degrees, n_rows=int(len(plan.perm_src)),
            seg_identity=seg_ident)
        segps[name] = plan.seg_perm
    return specs, segps


def build_problem(vertex_blocks, edge_blocks, *, dtype=None, device="cuda",
                  pad_edges_to_multiple: int = 1,
                  bucket_landmarks: bool = False,
                  static_kernels: bool = True,
                  state_dtype=None,
                  assembly_precision: str = "highest",
                  registry=None) -> Problem:
    """Build a :class:`Problem` from raw numpy blocks keyed by type name:

    ``vertex_blocks``: ``{name: (vids (N,), estimates (N, rep), fixed (N,),
    marginalized (N,))}``;
    ``edge_blocks``: ``{name: (vids (E, k) raw ids, meas (E, m), info (E, r, r),
    kernel (E,), delta (E,), active (E,), param (E, p))}``.

    Vertices are sorted by id within each type — the deterministic index
    mapping of the reference (``sparse_optimizer.cpp:168,504``) and of the
    JAX package, so both give the same tangent layout.

    ``bucket_landmarks=True`` lays every binary batch with one
    fully-marginalized slot out in landmark-degree buckets, for the
    implicit Schur solver: landmark types observed by one edge type are
    reordered into bucket order first (``vid_index``, ``estimates_by_vid``
    and ``fixed_flat`` follow the reorder; within-type vertex order is an
    internal layout choice).

    ``state_dtype`` (``dtype`` when None) is the dtype of the estimates and
    of the linearization (mixed precision: module docstring)."""
    vertex_arrays, sorted_vids, vid_index = {}, {}, {}
    for t, (vids, est, fx, mg) in vertex_blocks.items():
        order = np.argsort(np.asarray(vids), kind="stable")
        sv = np.asarray(vids, dtype=np.int64)[order]
        vertex_arrays[t] = (np.asarray(est, dtype=np.float64)[order],
                            np.asarray(fx, dtype=bool)[order],
                            np.asarray(mg, dtype=bool)[order])
        sorted_vids[t] = sv
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
    specs, segps = {}, {}
    if bucket_landmarks:
        _reorder_landmarks(vertex_arrays, sorted_vids, edge_arrays, registry)
        specs, segps = _bucket_rows(edge_arrays, vertex_arrays, registry)
    # built AFTER the reorder: ids follow their vertices
    for t, sv in sorted_vids.items():
        vid_index.update(zip(sv.tolist(), ((t, i) for i in range(len(sv)))))
    return _make_problem(vertex_arrays, edge_arrays, vid_index=vid_index,
                         dtype=dtype, device=device,
                         pad_edges_to_multiple=pad_edges_to_multiple,
                         assembly_precision=assembly_precision,
                         registry=registry, bucket_specs=specs, segps=segps,
                         static_kernels=static_kernels,
                         state_dtype=state_dtype)


def problem_from_numpy(vertices, edges, *, dtype=None, device="cuda",
                       vid_index=None, registry=None,
                       state_dtype=None) -> Problem:
    """A :class:`Problem` from arrays that are already in compiled form —
    e.g. a JAX ``Problem``'s ``p.estimates[t]``, ``p.data.fixed[t]``,
    ``p.marginalized[t]`` and ``p.data.edges[name]`` turned to numpy — so
    both packages optimize exactly the same arrays.

    ``vertices``: ``{type name: (estimates (N, rep), fixed (N,),
    marginalized (N,))}`` in the tangent layout order; ``edges``: ``{edge
    name: {vidx, meas, info, kernel, delta, active, param}}`` with local
    vertex indices."""
    return _make_problem(vertices, edges, vid_index=vid_index or {},
                         dtype=dtype, device=device, registry=registry,
                         state_dtype=state_dtype)


class _GraphTypes(NamedTuple):
    """The type tables :func:`build_problem` reads from a registry."""

    vertex_types: dict
    edge_types: dict


def compile_graph(graph, *, dtype=None, device="cuda", level: int = 0,
                  pad_edges_to_multiple: int = 1,
                  bucket_landmarks: bool = False,
                  static_kernels: bool = True,
                  state_dtype=None,
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
            np.array([r.fixed for r in recs], dtype=bool),
            np.array([r.marginalized for r in recs], dtype=bool))
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
    # the records' own types, over the registry's: a user-defined type
    # (``examples/circle_fit``) compiles without being registered, as in
    # the JAX package, whose blocks are keyed by the type objects
    types = _GraphTypes(dict(graph.registry.vertex_types),
                        dict(graph.registry.edge_types))
    for rec in graph.vertices().values():
        types.vertex_types[rec.vtype.name] = rec.vtype
    for e in graph.edges():
        types.edge_types[e.etype.name] = e.etype
    return build_problem(vertex_blocks, edge_blocks, dtype=dtype,
                         device=device,
                         pad_edges_to_multiple=pad_edges_to_multiple,
                         bucket_landmarks=bucket_landmarks,
                         static_kernels=static_kernels,
                         state_dtype=state_dtype,
                         assembly_precision=assembly_precision,
                         registry=types)
