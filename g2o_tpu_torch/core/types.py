"""Vertex/edge type descriptors and the tag registry — port of
``g2o_tpu/core/types.py``.

A descriptor holds plain functions on tensors (the reference framework's
virtual vertex/edge classes, ``g2o/core/base_vertex.h``, ``base_edge.h``,
and its string-tag ``Factory``, ``g2o/core/factory.h:47``).  A batch of
same-type edges is evaluated by calling the residual once on ``(E, ·)``
tensors: every residual works on the last axis only.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class VertexType:
    """A manifold vertex type.

    Attributes:
      name: unique name, also the default ``.g2o`` tag.
      rep_dim: length of the stored state vector (7 for SE3 = t + quat).
      tangent_dim: dof of the local perturbation (6 for SE3).
      oplus: ``(state, delta) -> state`` on the last axis.
      to_vector / from_vector: host-side (numpy) conversion between the
        stored state and its ``.g2o`` numbers (identity when None).
      tags: accepted ``.g2o`` tags when loading.
      io_dim: numbers of the state in a ``.g2o`` line (``rep_dim`` when
        None).
    """

    name: str
    rep_dim: int
    tangent_dim: int
    oplus: Callable
    to_vector: Optional[Callable] = None
    from_vector: Optional[Callable] = None
    tags: Sequence[str] = ()
    io_dim: Optional[int] = None

    @property
    def io_tags(self):
        return tuple(self.tags) if self.tags else (self.name,)

    @property
    def serialized_dim(self) -> int:
        return self.rep_dim if self.io_dim is None else self.io_dim


@dataclasses.dataclass(frozen=True)
class EdgeType:
    """An error-function edge type connecting fixed vertex types.

    Attributes:
      name: unique name, also the default ``.g2o`` tag.
      vertex_types: the connected vertex types, in slot order.
      residual_dim: error dimension r.
      residual: ``(states: tuple, measurement, param) -> (..., r)``
        (reference ``Edge::computeError``).
      meas_dim: length of the stored measurement vector.
      param_dim: length of the per-edge parameter vector (0 if none).
      num_params: how many parameter ids the edge references (their
        values are concatenated into ``param``).
      meas_to_vector / meas_from_vector: host-side (numpy) conversion
        between the stored measurement and its ``.g2o`` numbers.
      meas_io_dim: numbers of the measurement in a ``.g2o`` line
        (``meas_dim`` when None).
      info_from_io / info_to_io: ``(info, measurement) -> info`` between
        the information matrix on disk and the one in error coordinates
        (EdgeSE3Euler's Euler <-> quaternion conversion,
        ``types/slam3d_addons/edge_se3_euler.cpp:58-104``).
      tags: accepted ``.g2o`` tags when loading.
      dynamic_tag: the variable-arity ``.g2o`` tag of an edge type made
        per arity by a factory, written as ``TAG id... || count meas
        info`` (reference ``core/optimizable_graph.cpp:575-590``).
    """

    name: str
    vertex_types: Sequence[VertexType]
    residual_dim: int
    residual: Callable
    meas_dim: int
    param_dim: int = 0
    num_params: int = 1
    meas_to_vector: Optional[Callable] = None
    meas_from_vector: Optional[Callable] = None
    meas_io_dim: Optional[int] = None
    info_from_io: Optional[Callable] = None
    info_to_io: Optional[Callable] = None
    tags: Sequence[str] = ()
    dynamic_tag: Optional[str] = None

    @property
    def num_slots(self) -> int:
        return len(self.vertex_types)

    @property
    def serialized_meas_dim(self) -> int:
        return self.meas_dim if self.meas_io_dim is None else self.meas_io_dim

    @property
    def io_tags(self):
        return tuple(self.tags) if self.tags else (self.name,)


class TypeRegistry:
    """String-tag registry mapping ``.g2o`` tags to descriptors."""

    def __init__(self):
        self.vertex_types: dict[str, VertexType] = {}
        self.edge_types: dict[str, EdgeType] = {}
        self._vertex_by_tag: dict[str, VertexType] = {}
        self._edge_by_tag: dict[str, EdgeType] = {}
        self._dynamic_edge_by_tag: dict[str, Callable] = {}

    def register_vertex(self, vt: VertexType) -> VertexType:
        self.vertex_types[vt.name] = vt
        for tag in vt.io_tags:
            self._vertex_by_tag[tag] = vt
        return vt

    def register_edge(self, et: EdgeType) -> EdgeType:
        self.edge_types[et.name] = et
        for tag in et.io_tags:
            self._edge_by_tag[tag] = et
        return et

    def vertex_for_tag(self, tag: str) -> Optional[VertexType]:
        return self._vertex_by_tag.get(tag)

    def edge_for_tag(self, tag: str) -> Optional[EdgeType]:
        return self._edge_by_tag.get(tag)

    def alias_tag(self, alias: str, existing_tag: str) -> None:
        """Accept ``alias`` wherever ``existing_tag`` is accepted (the
        reference's deprecated spellings,
        ``types/deprecated/slam3d/types_slam3d.cpp:39-52``)."""
        vt = self._vertex_by_tag.get(existing_tag)
        if vt is not None:
            self._vertex_by_tag[alias] = vt
            return
        et = self._edge_by_tag.get(existing_tag)
        if et is not None:
            self._edge_by_tag[alias] = et
            return
        raise KeyError(f"alias target {existing_tag!r} not registered")

    def register_dynamic_edge(self, tag: str, factory: Callable) -> None:
        """``factory(k) -> EdgeType`` makes the arity-``k`` type of a
        variable-arity tag."""
        self._dynamic_edge_by_tag[tag] = factory

    def dynamic_edge_for_tag(self, tag: str) -> Optional[Callable]:
        return self._dynamic_edge_by_tag.get(tag)

    def known_tags(self):
        return sorted(set(self._vertex_by_tag) | set(self._edge_by_tag)
                      | set(self._dynamic_edge_by_tag))


# the global registry (type libraries register into it at import time)
REGISTRY = TypeRegistry()


def register_vertex(vt: VertexType) -> VertexType:
    return REGISTRY.register_vertex(vt)


def register_edge(et: EdgeType) -> EdgeType:
    return REGISTRY.register_edge(et)


def upper_triangular_to_full(vals: Sequence[float], dim: int) -> np.ndarray:
    """Expand the row-major upper-triangular information entries of the
    ``.g2o`` format into a full symmetric matrix."""
    vals = np.asarray(vals, dtype=np.float64)
    if vals.shape != (dim * (dim + 1) // 2,):
        raise ValueError(f"expected {dim * (dim + 1) // 2} information "
                         f"entries, got {vals.size}")
    m = np.zeros((dim, dim))
    iu = np.triu_indices(dim)
    m[iu] = vals
    m.T[iu] = vals
    return m


def full_to_upper_triangular(m: np.ndarray) -> np.ndarray:
    return np.asarray(m)[np.triu_indices(m.shape[0])]
