"""Host-side mutable graph — port of ``g2o_tpu/core/graph.py``.

Plays the role of the reference ``HyperGraph``/``OptimizableGraph``: vertices
are added by id, edges connect vertices and carry measurement, information
and robust kernel, vertices can be fixed (gauge), edges have a level and the
fork's per-edge active flag.  :meth:`Graph.compile` freezes the records into
a structure-of-arrays :class:`~g2o_tpu_torch.core.problem.Problem` of
tensors on an explicit device.
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

    # -- vertices ----------------------------------------------------------

    def add_vertex(self, vid: int, vtype, estimate, *, fixed=False):
        if isinstance(vtype, str):
            vtype = self.registry.vertex_types[vtype]
        est = np.asarray(estimate, dtype=np.float64).reshape(-1)
        if est.shape[0] != vtype.rep_dim:
            raise ValueError(
                f"vertex {vid}: expected state of dim {vtype.rep_dim} for "
                f"{vtype.name}, got {est.shape[0]}")
        if vid in self._vertices:
            raise ValueError(f"duplicate vertex id {vid}")
        self._vertices[vid] = _VertexRec(vid, vtype, est, bool(fixed))
        return vid

    def vertex(self, vid: int) -> _VertexRec:
        return self._vertices[vid]

    def set_fixed(self, vid: int, fixed: bool = True):
        self._vertices[vid].fixed = bool(fixed)

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

    # -- compile -----------------------------------------------------------

    def compile(self, *, dtype=None, device="cpu", level: int = 0,
                pad_edges_to_multiple: int = 1,
                assembly_precision: str = "highest"):
        """Freeze the edges of ``level`` into a :class:`Problem` of
        ``dtype`` tensors on ``device`` (float64 when ``dtype`` is None)."""
        from g2o_tpu_torch.core.problem import compile_graph

        return compile_graph(self, dtype=dtype, device=device, level=level,
                             pad_edges_to_multiple=pad_edges_to_multiple,
                             assembly_precision=assembly_precision)
