"""Host-side mutable graph — port of ``g2o_tpu/core/graph.py``.

Plays the role of the reference ``HyperGraph``/``OptimizableGraph``: vertices
are added by id, edges connect vertices and carry measurement, information
and robust kernel, vertices can be fixed (gauge) or marginalized (eliminated
by a Schur solver), edges have a level and the fork's per-edge active flag.
:meth:`Graph.compile` freezes the records into a structure-of-arrays
:class:`~g2o_tpu_torch.core.problem.Problem` of tensors on the CUDA card,
or on the CPU when the caller asks for ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from g2o_tpu_torch.core.types import REGISTRY, EdgeType, VertexType
from g2o_tpu_torch.ops import robust as robust_mod


@dataclasses.dataclass
class _VertexRec:
    vid: int
    vtype: VertexType
    estimate: np.ndarray
    fixed: bool = False
    marginalized: bool = False


@dataclasses.dataclass
class _EdgeRec:
    etype: EdgeType
    vids: tuple
    measurement: np.ndarray
    information: np.ndarray
    kernel: int = robust_mod.NONE
    delta: float = 1.0
    level: int = 0
    active: bool = True
    param_id: Optional[tuple] = None


class Graph:
    """Mutable problem description.  Build, then :meth:`compile`."""

    def __init__(self, registry=None):
        self.registry = registry or REGISTRY
        self._vertices: dict[int, _VertexRec] = {}
        self._edges: list[_EdgeRec] = []
        self._parameters: dict[int, np.ndarray] = {}
        # raw sensor-data payload lines attached to vertices (reference
        # ``Data``/``DataContainer``, ``hyper_graph.h:95,119``, e.g.
        # ROBOTLASER1), kept verbatim so that a save writes them back
        self._vertex_data: dict[int, list] = {}

    # -- vertices ----------------------------------------------------------

    def add_vertex(self, vid: int, vtype, estimate, *, fixed=False,
                   marginalized=False):
        if isinstance(vtype, str):
            vtype = self.registry.vertex_types[vtype]
        est = np.asarray(estimate, dtype=np.float64).reshape(-1)
        if est.shape[0] != vtype.rep_dim:
            raise ValueError(
                f"vertex {vid}: expected state of dim {vtype.rep_dim} for "
                f"{vtype.name}, got {est.shape[0]}")
        if vid in self._vertices:
            raise ValueError(f"duplicate vertex id {vid}")
        self._vertices[vid] = _VertexRec(vid, vtype, est, bool(fixed),
                                         bool(marginalized))
        return vid

    def has_vertex(self, vid: int) -> bool:
        return vid in self._vertices

    def vertex(self, vid: int) -> _VertexRec:
        return self._vertices[vid]

    def set_fixed(self, vid: int, fixed: bool = True):
        self._vertices[vid].fixed = bool(fixed)

    def set_marginalized(self, vid: int, marginalized: bool = True):
        self._vertices[vid].marginalized = bool(marginalized)

    def set_estimate(self, vid: int, estimate):
        rec = self._vertices[vid]
        est = np.asarray(estimate, dtype=np.float64).reshape(-1)
        if est.shape[0] != rec.vtype.rep_dim:
            raise ValueError(
                f"vertex {vid}: expected state of dim {rec.vtype.rep_dim} "
                f"for {rec.vtype.name}, got {est.shape[0]}")
        rec.estimate = est

    def add_vertex_data(self, vid: int, raw_line: str):
        """Attach a raw data payload line (e.g. a laser scan) to a vertex."""
        if vid not in self._vertices:
            raise ValueError(f"unknown vertex id {vid}")
        self._vertex_data.setdefault(vid, []).append(raw_line)

    def vertex_data(self, vid: int):
        return self._vertex_data.get(vid, [])

    def remove_vertex(self, vid: int):
        """Remove a vertex, every edge incident to it (reference
        ``HyperGraph::removeVertex`` detaches edges) and its data payloads,
        which a later vertex of the same id must not inherit; False when
        there is no such vertex."""
        if vid not in self._vertices:
            return False
        self._edges = [e for e in self._edges if vid not in e.vids]
        del self._vertices[vid]
        self._vertex_data.pop(vid, None)
        return True

    @property
    def num_vertices(self):
        return len(self._vertices)

    @property
    def num_edges(self):
        return len(self._edges)

    def vertices(self):
        return self._vertices

    def edges(self):
        return self._edges

    # -- parameters --------------------------------------------------------

    def add_parameter(self, pid: int, value):
        """Shared parameter block (e.g. a sensor offset) resolved by id at
        compile time (``g2o/core/parameter.h:36``)."""
        self._parameters[pid] = np.asarray(value, dtype=np.float64).reshape(-1)

    def parameter(self, pid: int) -> np.ndarray:
        return self._parameters[pid]

    def parameters(self):
        return self._parameters

    # -- edges -------------------------------------------------------------

    def add_edge(self, etype, vids: Sequence[int], measurement, information,
                 *, kernel=None, delta: float = 1.0, level: int = 0,
                 active: bool = True, param_id=None):
        if isinstance(etype, str):
            etype = self.registry.edge_types[etype]
        vids = tuple(int(v) for v in vids)
        if len(vids) != etype.num_slots:
            raise ValueError(f"{etype.name}: expected {etype.num_slots} "
                             f"vertices, got {len(vids)}")
        for slot, (vid, vt) in enumerate(zip(vids, etype.vertex_types)):
            rec = self._vertices.get(vid)
            if rec is None:
                raise ValueError(f"{etype.name}: unknown vertex id {vid}")
            if rec.vtype is not vt:
                raise ValueError(
                    f"{etype.name} slot {slot}: vertex {vid} has type "
                    f"{rec.vtype.name}, expected {vt.name}")
        meas = np.asarray(measurement, dtype=np.float64).reshape(-1)
        if meas.shape[0] != etype.meas_dim:
            raise ValueError(f"{etype.name}: measurement dim "
                             f"{meas.shape[0]} != {etype.meas_dim}")
        info = np.asarray(information, dtype=np.float64)
        if info.shape == ():
            info = info * np.eye(etype.residual_dim)
        info = info.reshape(etype.residual_dim, etype.residual_dim)
        if isinstance(kernel, str):
            kernel = robust_mod.KERNEL_IDS[kernel]
        elif kernel is None:
            kernel = robust_mod.NONE
        if etype.param_dim:
            if param_id is None:
                raise ValueError(f"{etype.name}: param_id required")
            if isinstance(param_id, (tuple, list)):
                param_id = tuple(int(x) for x in param_id)
            else:
                param_id = (int(param_id),)
            if len(param_id) != etype.num_params:
                raise ValueError(f"{etype.name}: expected "
                                 f"{etype.num_params} param ids")
        self._edges.append(_EdgeRec(etype, vids, meas, info, int(kernel),
                                    float(delta), int(level), bool(active),
                                    param_id))
        return len(self._edges) - 1

    def set_robust_kernel(self, kernel, delta: float = 1.0, *, etype=None):
        """Attach a robust kernel to every edge (optionally of one type) —
        the CLI ``-robustKernel`` flow (``apps/g2o_cli/g2o.cpp:333-359``)."""
        if isinstance(kernel, str):
            kernel = robust_mod.KERNEL_IDS[kernel]
        if isinstance(etype, EdgeType):
            etype = etype.name
        for e in self._edges:
            if etype is None or e.etype.name == etype:
                e.kernel = int(kernel)
                e.delta = float(delta)

    # -- sanity checks -----------------------------------------------------

    def verify_information_matrices(self, verbose: bool = False) -> bool:
        """Check every edge's information matrix is symmetric positive
        (semi)definite — reference ``verifyInformationMatrices``
        (``g2o/core/optimizable_graph.h:630``)."""
        ok = True
        for i, e in enumerate(self._edges):
            info = e.information
            if not np.allclose(info, info.T, atol=1e-9):
                ok = False
                if verbose:
                    print(f"edge {i} ({e.etype.name} {e.vids}): information "
                          f"matrix not symmetric")
                continue
            ev = np.linalg.eigvalsh(info)
            if ev.min() < -1e-9:
                ok = False
                if verbose:
                    print(f"edge {i} ({e.etype.name} {e.vids}): information "
                          f"matrix not PSD (min eig {ev.min():.3g})")
        return ok

    def check_finite(self, verbose: bool = False) -> bool:
        """NaN/Inf check over estimates, measurements and information
        matrices — the debug checks of the reference
        (``sparse_optimizer.cpp:80-88,252-263``)."""
        ok = True
        for vid, rec in self._vertices.items():
            if not np.isfinite(rec.estimate).all():
                ok = False
                if verbose:
                    print(f"vertex {vid}: non-finite estimate")
        for i, e in enumerate(self._edges):
            if not (np.isfinite(e.measurement).all()
                    and np.isfinite(e.information).all()):
                ok = False
                if verbose:
                    print(f"edge {i} ({e.etype.name}): non-finite data")
        return ok

    # -- compile -----------------------------------------------------------

    def compile(self, *, dtype=None, device="cuda", level: int = 0,
                pad_edges_to_multiple: int = 1,
                bucket_landmarks: bool = False,
                static_kernels: bool = True,
                state_dtype=None,
                assembly_precision: str = "highest"):
        """Freeze the edges of ``level`` into a :class:`Problem` of
        ``dtype`` tensors on ``device`` (float64 when ``dtype`` is None);
        without a CUDA card the caller must pass ``device="cpu"``.
        ``bucket_landmarks=True`` gives the landmark-bucketed layout of the
        implicit Schur solver.  ``static_kernels=False`` keeps the robust
        kernel dispatch per row (no batch-uniform kernel id is frozen), as
        needed when kernel ids are written after compile — the
        capacity-padded incremental mode.  ``state_dtype`` wider than
        ``dtype`` keeps the estimates and the whole linearization wide and
        hands the solvers its results rounded to ``dtype`` once (mixed
        precision, ``core/problem.py``)."""
        from g2o_tpu_torch.core.problem import compile_graph

        return compile_graph(self, dtype=dtype, device=device, level=level,
                             pad_edges_to_multiple=pad_edges_to_multiple,
                             bucket_landmarks=bucket_landmarks,
                             static_kernels=static_kernels,
                             state_dtype=state_dtype,
                             assembly_precision=assembly_precision)
