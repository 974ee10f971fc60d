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
      tags: accepted ``.g2o`` tags when loading.
    """

    name: str
    rep_dim: int
    tangent_dim: int
    oplus: Callable
    tags: Sequence[str] = ()

    @property
    def io_tags(self):
        return tuple(self.tags) if self.tags else (self.name,)


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
      tags: accepted ``.g2o`` tags when loading.
    """

    name: str
    vertex_types: Sequence[VertexType]
    residual_dim: int
    residual: Callable
    meas_dim: int
    param_dim: int = 0
    num_params: int = 1
    tags: Sequence[str] = ()

    @property
    def num_slots(self) -> int:
        return len(self.vertex_types)

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
