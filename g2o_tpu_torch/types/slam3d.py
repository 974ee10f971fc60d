"""3D SLAM types — port of ``g2o_tpu/types/slam3d.py`` (the reference
library is ``g2o/types/slam3d``).

* ``VERTEX_SE3:QUAT``: state (tx, ty, tz, qx, qy, qz, qw); update is a
  right multiplication by ``fromVectorMQT(delta)``
  (``g2o/types/slam3d/vertex_se3.h:105-114``).
* ``VERTEX_TRACKXYZ``: a 3D point with an additive update (also the BAL
  landmark).
* ``EDGE_SE3:QUAT``: error = ``toVectorMQT(Z^-1 Xi^-1 Xj)``
  (``g2o/types/slam3d/edge_se3.cpp:77-82``).
* ``EDGE_SE3_PRIOR``: error = ``toVectorMQT(Z^-1 (X O))`` with the sensor
  offset O from ``PARAMS_SE3OFFSET`` (``edge_se3_prior.cpp``).
* ``EDGE_SE3_TRACKXYZ``: error = ``(X O)^-1 l - z``
  (``edge_se3_pointxyz.cpp``); ``EDGE_SE3_OFFSET``: two poses through
  per-end offsets; ``EDGE_PROJECT_DEPTH`` / ``EDGE_PROJECT_DISPARITY``:
  camera observations through ``PARAMS_CAMERACALIB``; the point-point and
  point-prior edges; the variable-arity ``EDGE_SE3_LOTSOF_XYZ``.
* The deprecated library's ``DEPRECATED_*`` spellings load as aliases.
"""

from __future__ import annotations

import torch

from g2o_tpu_torch.core.types import (REGISTRY, EdgeType, VertexType,
                                      register_edge, register_vertex)
from g2o_tpu_torch.ops import lie


def _point_oplus(x, d):
    return x + d


VertexSE3 = register_vertex(VertexType(
    name="VERTEX_SE3:QUAT",
    rep_dim=7,
    tangent_dim=6,
    oplus=lie.se3_oplus,
    tags=("VERTEX_SE3:QUAT",),
))

VertexPointXYZ = register_vertex(VertexType(
    name="VERTEX_TRACKXYZ",
    rep_dim=3,
    tangent_dim=3,
    oplus=_point_oplus,
    tags=("VERTEX_TRACKXYZ", "VERTEX_POINT_XYZ", "VERTEX_XYZ"),
))


def _edge_se3_residual(states, meas, param):
    xi, xj = states
    delta = lie.se3_compose(lie.se3_inverse(xi), xj)
    err = lie.se3_compose(lie.se3_inverse(meas), delta)
    return lie.se3_to_mqt(err)


EdgeSE3 = register_edge(EdgeType(
    name="EDGE_SE3:QUAT",
    vertex_types=(VertexSE3, VertexSE3),
    residual_dim=6,
    residual=_edge_se3_residual,
    meas_dim=7,
    tags=("EDGE_SE3:QUAT",),
))


def _edge_se3_trackxyz_residual(states, meas, param):
    x, l = states
    sensor = lie.se3_compose(x, param)
    return lie.se3_act(lie.se3_inverse(sensor), l) - meas


EdgeSE3PointXYZ = register_edge(EdgeType(
    name="EDGE_SE3_TRACKXYZ",
    vertex_types=(VertexSE3, VertexPointXYZ),
    residual_dim=3,
    residual=_edge_se3_trackxyz_residual,
    meas_dim=3,
    param_dim=7,
    tags=("EDGE_SE3_TRACKXYZ",),
))


def _edge_se3_prior_residual(states, meas, param):
    (x,) = states
    n = lie.se3_compose(x, param)
    err = lie.se3_compose(lie.se3_inverse(meas), n)
    return lie.se3_to_mqt(err)


EdgeSE3Prior = register_edge(EdgeType(
    name="EDGE_SE3_PRIOR",
    vertex_types=(VertexSE3,),
    residual_dim=6,
    residual=_edge_se3_prior_residual,
    meas_dim=7,
    param_dim=7,
    tags=("EDGE_SE3_PRIOR",),
))


def _edge_pointxyz_residual(states, meas, param):
    p1, p2 = states
    return (p2 - p1) - meas


EdgePointXYZ = register_edge(EdgeType(
    name="EDGE_POINTXYZ",
    vertex_types=(VertexPointXYZ, VertexPointXYZ),
    residual_dim=3,
    residual=_edge_pointxyz_residual,
    meas_dim=3,
    tags=("EDGE_POINTXYZ",),
))


def _edge_xyz_prior_residual(states, meas, param):
    (p,) = states
    return p - meas


EdgeXYZPrior = register_edge(EdgeType(
    name="EDGE_POINTXYZ_PRIOR",
    vertex_types=(VertexPointXYZ,),
    residual_dim=3,
    residual=_edge_xyz_prior_residual,
    meas_dim=3,
    tags=("EDGE_POINTXYZ_PRIOR",),
))


_LOTS_OF_XYZ_CACHE: dict = {}


def make_edge_se3_lots_of_xyz(k: int) -> EdgeType:
    """Variable-arity 3D landmark edge (reference ``EdgeSE3LotsOfXYZ``,
    ``edge_se3_lotsofxyz.h``): one cached edge type per observed-point
    count ``k``, so edges of equal arity batch together."""
    et = _LOTS_OF_XYZ_CACHE.get(k)
    if et is not None:
        return et

    def residual(states, meas, param):
        inv = lie.se3_inverse(states[0])
        preds = [lie.se3_act(inv, p) for p in states[1:]]
        return torch.cat(preds, dim=-1) - meas

    et = register_edge(EdgeType(
        name=f"EDGE_SE3_LOTSOF_XYZ_{k}",
        vertex_types=(VertexSE3,) + (VertexPointXYZ,) * k,
        residual_dim=3 * k,
        residual=residual,
        meas_dim=3 * k,
        tags=(f"EDGE_SE3_LOTSOF_XYZ_{k}",),
        dynamic_tag="EDGE_SE3_LOTSOF_XYZ",
    ))
    _LOTS_OF_XYZ_CACHE[k] = et
    return et


# variable-arity text lines (reference tag registration
# ``types_slam3d.cpp:56``)
REGISTRY.register_dynamic_edge("EDGE_SE3_LOTSOF_XYZ",
                               make_edge_se3_lots_of_xyz)


def _edge_se3_offset_residual(states, meas, param):
    """Reference ``EdgeSE3Offset::computeError``
    (``g2o/types/slam3d/edge_se3_offset.cpp:102-105``): two poses observed
    through per-end sensor offsets, params = [offset_from(7),
    offset_to(7)]; error = toVectorMQT(Z^-1 (Xi Oi)^-1 (Xj Oj))."""
    xi, xj = states
    ni = lie.se3_compose(xi, param[..., :7])
    nj = lie.se3_compose(xj, param[..., 7:14])
    delta = lie.se3_compose(lie.se3_inverse(ni), nj)
    return lie.se3_to_mqt(lie.se3_compose(lie.se3_inverse(meas), delta))


EdgeSE3Offset = register_edge(EdgeType(
    name="EDGE_SE3_OFFSET",
    vertex_types=(VertexSE3, VertexSE3),
    residual_dim=6,
    residual=_edge_se3_offset_residual,
    meas_dim=7,
    param_dim=14,
    num_params=2,
    tags=("EDGE_SE3_OFFSET",),
))


def _w2i(x, param, pw):
    """World-to-image map of a ParameterCamera value [offset(7), fx, fy,
    cx, cy] (``g2o/types/slam3d/parameter_camera.cpp:63-84``):
    ``K (X O)^-1 p_world`` before the division by depth."""
    sensor = lie.se3_compose(x, param[..., :7])
    p = lie.se3_act(lie.se3_inverse(sensor), pw)
    fx, fy, cx, cy = (param[..., 7], param[..., 8], param[..., 9],
                      param[..., 10])
    return torch.stack([fx * p[..., 0] + cx * p[..., 2],
                        fy * p[..., 1] + cy * p[..., 2], p[..., 2]], dim=-1)


def _edge_project_depth_residual(states, meas, param):
    """Reference ``EdgeSE3PointXYZDepth::computeError``
    (``edge_se3_pointxyz_depth.cpp:91-104``): error = [u/w, v/w, w] - z."""
    x, l = states
    p = _w2i(x, param, l)
    perr = torch.stack([p[..., 0] / p[..., 2], p[..., 1] / p[..., 2],
                        p[..., 2]], dim=-1)
    return perr - meas


EdgeSE3PointXYZDepth = register_edge(EdgeType(
    name="EDGE_PROJECT_DEPTH",
    vertex_types=(VertexSE3, VertexPointXYZ),
    residual_dim=3,
    residual=_edge_project_depth_residual,
    meas_dim=3,
    param_dim=11,
    tags=("EDGE_PROJECT_DEPTH",),
))


def _edge_project_disparity_residual(states, meas, param):
    """Reference ``EdgeSE3PointXYZDisparity::computeError``
    (``edge_se3_pointxyz_disparity.cpp:97-122``): error = [u/w, v/w, 1/w]
    - z."""
    x, l = states
    p = _w2i(x, param, l)
    perr = torch.stack([p[..., 0] / p[..., 2], p[..., 1] / p[..., 2],
                        1.0 / p[..., 2]], dim=-1)
    return perr - meas


EdgeSE3PointXYZDisparity = register_edge(EdgeType(
    name="EDGE_PROJECT_DISPARITY",
    vertex_types=(VertexSE3, VertexPointXYZ),
    residual_dim=3,
    residual=_edge_project_disparity_residual,
    meas_dim=3,
    param_dim=11,
    tags=("EDGE_PROJECT_DISPARITY",),
))


# the deprecated slam3d library's tag spellings
# (``types/deprecated/slam3d/types_slam3d.cpp:36-52``): files written with
# it still carry them
for _dep, _cur in (
    ("DEPRECATED_VERTEX_SE3:QUAT", "VERTEX_SE3:QUAT"),
    ("DEPRECATED_EDGE_SE3:QUAT", "EDGE_SE3:QUAT"),
    ("DEPRECATED_VERTEX_TRACKXYZ", "VERTEX_TRACKXYZ"),
    ("DEPRECATED_EDGE_SE3_TRACKXYZ", "EDGE_SE3_TRACKXYZ"),
    ("DEPRECATED_EDGE_SE3_PRIOR", "EDGE_SE3_PRIOR"),
    ("DEPRECATED_EDGE_SE3_OFFSET", "EDGE_SE3_OFFSET"),
    ("DEPRECATED_EDGE_PROJECT_DISPARITY", "EDGE_PROJECT_DISPARITY"),
    ("DEPRECATED_EDGE_PROJECT_DEPTH", "EDGE_PROJECT_DEPTH"),
):
    REGISTRY.alias_tag(_dep, _cur)
