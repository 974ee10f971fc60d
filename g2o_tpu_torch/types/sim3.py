"""Sim3 types — port of ``g2o_tpu/types/sim3.py`` (the reference library is
``g2o/types/sim3``, scale-drift-aware monocular loop closing).

Conventions (``g2o/types/sim3/types_seven_dof_expmap.h``):

* ``VERTEX_SIM3:EXPMAP``: the estimate is a Sim3 (t, q, s); the update is
  a left multiplication ``S <- Sim3(update) * S`` with update =
  [omega(3), upsilon(3), sigma] (``:73-82``).  The two pinhole intrinsics
  sets the reference keeps on the vertex (``:84-99``) ride in the state's
  tail (dims 8..15 = f1x f1y c1x c1y f2x f2y c2x c2y), which ``oplus``
  never touches: the state is 16 numbers.
* ``VERTEX_SIM3:EXPMAP:FIXSCALE``: the reference's ``_fix_scale`` flag
  (``:77-78``) as its own type, whose update drops the scale component.
* ``EDGE_SIM3:EXPMAP``: error = ``(Z S1 S2^-1).log()`` (``:117-125``).
* ``EDGE_PROJECT_SIM3_XYZ:EXPMAP`` / ``EDGE_PROJECT_INVERSE_SIM3_XYZ:EXPMAP``:
  a point projected through S (first intrinsics) or S^-1 (second).
* A ``.g2o`` vertex line holds the log of the *inverse* estimate
  (cam2world) and the first intrinsics set, 11 numbers
  (``types_seven_dof_expmap.cpp:66-102``); an edge line the log of the
  inverse measurement (``:104-136``).  Those conversions run on the host
  in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from g2o_tpu_torch.core.types import (EdgeType, VertexType, register_edge,
                                      register_vertex)
from g2o_tpu_torch.ops import lie
from g2o_tpu_torch.types.slam3d import VertexPointXYZ

REP_DIM = 16  # [t(3), q(4), s(1), f1(2), c1(2), f2(2), c2(2)]


def _sim3_part(x):
    return x[..., :8]


def _sim3_oplus(x, delta):
    s_new = lie.sim3_compose(lie.sim3_exp(delta), _sim3_part(x))
    q = lie.quat_normalize(s_new[..., 3:7])
    return torch.cat([s_new[..., :3], q, s_new[..., 7:8], x[..., 8:]],
                     dim=-1)


def _sim3_oplus_fix_scale(x, delta):
    delta = torch.cat([delta[..., :6], torch.zeros_like(delta[..., 6:7])],
                      dim=-1)
    return _sim3_oplus(x, delta)


def _host(fn, v):
    """``fn`` on a float64 CPU tensor of ``v``, back to numpy."""
    return fn(torch.as_tensor(np.asarray(v, dtype=np.float64))).numpy()


def _sim3_io_from_vector(v):
    """11 numbers: log of cam2world, f1(2), c1(2) -> the 16-number state."""
    v = np.asarray(v, dtype=np.float64)
    est = _host(lambda t: lie.sim3_inverse(lie.sim3_exp(t)), v[:7])
    f1, c1 = v[7:9], v[9:11]
    return np.concatenate([est, f1, c1, f1, c1])


def _sim3_io_to_vector(x):
    x = np.asarray(x, dtype=np.float64)
    lv = _host(lambda t: lie.sim3_log(lie.sim3_inverse(t)), x[:8])
    return np.concatenate([lv, x[8:10], x[10:12]])


VertexSim3Expmap = register_vertex(VertexType(
    name="VERTEX_SIM3:EXPMAP",
    rep_dim=REP_DIM,
    tangent_dim=7,
    oplus=_sim3_oplus,
    to_vector=_sim3_io_to_vector,
    from_vector=_sim3_io_from_vector,
    tags=("VERTEX_SIM3:EXPMAP",),
    io_dim=11,
))

VertexSim3ExpmapFixScale = register_vertex(VertexType(
    name="VERTEX_SIM3:EXPMAP:FIXSCALE",
    rep_dim=REP_DIM,
    tangent_dim=7,
    oplus=_sim3_oplus_fix_scale,
    to_vector=_sim3_io_to_vector,
    from_vector=_sim3_io_from_vector,
    tags=("VERTEX_SIM3:EXPMAP:FIXSCALE",),
    io_dim=11,
))


def _edge_sim3_residual(states, meas, param):
    s1, s2 = states
    err = lie.sim3_compose(meas[..., :8],
                           lie.sim3_compose(_sim3_part(s1),
                                            lie.sim3_inverse(_sim3_part(s2))))
    return lie.sim3_log(err)


def _edge_sim3_meas_from_vector(v):
    return _host(lambda t: lie.sim3_inverse(lie.sim3_exp(t)),
                 np.asarray(v)[:7])


def _edge_sim3_meas_to_vector(m):
    return _host(lambda t: lie.sim3_log(lie.sim3_inverse(t)),
                 np.asarray(m)[:8])


EdgeSim3 = register_edge(EdgeType(
    name="EDGE_SIM3:EXPMAP",
    vertex_types=(VertexSim3Expmap, VertexSim3Expmap),
    residual_dim=7,
    residual=_edge_sim3_residual,
    meas_dim=8,
    meas_to_vector=_edge_sim3_meas_to_vector,
    meas_from_vector=_edge_sim3_meas_from_vector,
    tags=("EDGE_SIM3:EXPMAP",),
    meas_io_dim=7,
))


def _project2(p):
    return p[..., :2] / p[..., 2:3]


def _edge_sim3_project_residual(states, meas, param):
    """obs - cam_map1(project(S p)) (``types_seven_dof_expmap.h:149-156``)."""
    point, s = states
    uv = _project2(lie.sim3_act(_sim3_part(s), point))
    return meas - (uv * s[..., 8:10] + s[..., 10:12])


EdgeSim3ProjectXYZ = register_edge(EdgeType(
    name="EDGE_PROJECT_SIM3_XYZ:EXPMAP",
    vertex_types=(VertexPointXYZ, VertexSim3Expmap),
    residual_dim=2,
    residual=_edge_sim3_project_residual,
    meas_dim=2,
    tags=("EDGE_PROJECT_SIM3_XYZ:EXPMAP",),
))


def _edge_inverse_sim3_project_residual(states, meas, param):
    """obs - cam_map2(project(S^-1 p)) (``:170-176``)."""
    point, s = states
    uv = _project2(lie.sim3_act(lie.sim3_inverse(_sim3_part(s)), point))
    return meas - (uv * s[..., 12:14] + s[..., 14:16])


EdgeInverseSim3ProjectXYZ = register_edge(EdgeType(
    name="EDGE_PROJECT_INVERSE_SIM3_XYZ:EXPMAP",
    vertex_types=(VertexPointXYZ, VertexSim3Expmap),
    residual_dim=2,
    residual=_edge_inverse_sim3_project_residual,
    meas_dim=2,
    tags=("EDGE_PROJECT_INVERSE_SIM3_XYZ:EXPMAP",),
))
