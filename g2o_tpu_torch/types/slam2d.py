"""2D SLAM vertex/edge types — port of ``g2o_tpu/types/slam2d.py`` (the
reference library is ``g2o/types/slam2d``).

* ``VERTEX_SE2``: state (x, y, theta); update is additive with angle
  normalisation (``g2o/types/slam2d/vertex_se2.h:51-58``).
* ``VERTEX_XY``: a 2D point with an additive update.
* ``EDGE_SE2``: error = ``(Z^-1 (Xi^-1 Xj)).toVector()``
  (``g2o/types/slam2d/edge_se2.h:46-52``).
* ``EDGE_SE2_XY``: error = ``(Xi^-1 * l) - z``
  (``g2o/types/slam2d/edge_se2_pointxy.h``).
* priors: ``EDGE_PRIOR_SE2`` error = ``(Z^-1 X).toVector()``,
  ``EDGE_PRIOR_XY`` error = ``x - z``; and the bearing, calibration,
  offset, two-point and variable-arity landmark edges below.
"""

from __future__ import annotations

import torch

from g2o_tpu_torch.core.types import (REGISTRY, EdgeType, VertexType,
                                      register_edge, register_vertex)
from g2o_tpu_torch.ops import lie


def _point_oplus(x, d):
    return x + d


VertexSE2 = register_vertex(VertexType(
    name="VERTEX_SE2",
    rep_dim=3,
    tangent_dim=3,
    oplus=lie.se2_oplus,
    tags=("VERTEX_SE2",),
))

VertexPointXY = register_vertex(VertexType(
    name="VERTEX_XY",
    rep_dim=2,
    tangent_dim=2,
    oplus=_point_oplus,
    tags=("VERTEX_XY", "VERTEX_POINT_XY"),
))


def _edge_se2_residual(states, meas, param):
    xi, xj = states
    delta = lie.se2_compose(lie.se2_inverse(xi), xj)
    return lie.se2_compose(lie.se2_inverse(meas), delta)


EdgeSE2 = register_edge(EdgeType(
    name="EDGE_SE2",
    vertex_types=(VertexSE2, VertexSE2),
    residual_dim=3,
    residual=_edge_se2_residual,
    meas_dim=3,
    tags=("EDGE_SE2",),
))


def _edge_se2_xy_residual(states, meas, param):
    xi, l = states
    return lie.se2_act(lie.se2_inverse(xi), l) - meas


EdgeSE2PointXY = register_edge(EdgeType(
    name="EDGE_SE2_XY",
    vertex_types=(VertexSE2, VertexPointXY),
    residual_dim=2,
    residual=_edge_se2_xy_residual,
    meas_dim=2,
    tags=("EDGE_SE2_XY", "EDGE_SE2_POINT_XY"),
))


def _edge_se2_xy_bearing_residual(states, meas, param):
    """Bearing-only landmark observation
    (``g2o/types/slam2d/edge_se2_pointxy_bearing.h``)."""
    xi, l = states
    p = lie.se2_act(lie.se2_inverse(xi), l)
    # double-where guard: d atan2 at (0, 0) is 0/0 in reverse mode, reached
    # when a landmark estimate coincides with the pose origin
    px, py = p[..., 0], p[..., 1]
    sel = px * px + py * py > 0
    bearing = torch.atan2(torch.where(sel, py, 0.0),
                          torch.where(sel, px, 1.0))
    return lie.normalize_angle(bearing[..., None] - meas)


EdgeSE2PointXYBearing = register_edge(EdgeType(
    name="EDGE_BEARING_SE2_XY",
    vertex_types=(VertexSE2, VertexPointXY),
    residual_dim=1,
    residual=_edge_se2_xy_bearing_residual,
    meas_dim=1,
    tags=("EDGE_BEARING_SE2_XY",),
))


def _edge_prior_se2_residual(states, meas, param):
    (x,) = states
    return lie.se2_compose(lie.se2_inverse(meas), x)


EdgeSE2Prior = register_edge(EdgeType(
    name="EDGE_PRIOR_SE2",
    vertex_types=(VertexSE2,),
    residual_dim=3,
    residual=_edge_prior_se2_residual,
    meas_dim=3,
    tags=("EDGE_PRIOR_SE2",),
))


def _edge_prior_xy_residual(states, meas, param):
    (x,) = states
    return x - meas


EdgeXYPrior = register_edge(EdgeType(
    name="EDGE_PRIOR_XY",
    vertex_types=(VertexPointXY,),
    residual_dim=2,
    residual=_edge_prior_xy_residual,
    meas_dim=2,
    tags=("EDGE_PRIOR_XY",),
))


def _edge_pointxy_residual(states, meas, param):
    p1, p2 = states
    return (p2 - p1) - meas


EdgePointXY = register_edge(EdgeType(
    name="EDGE_POINTXY",
    vertex_types=(VertexPointXY, VertexPointXY),
    residual_dim=2,
    residual=_edge_pointxy_residual,
    meas_dim=2,
    tags=("EDGE_POINTXY",),
))


def _edge_se2_xy_prior_residual(states, meas, param):
    """Position-only prior on an SE2 pose
    (``g2o/types/slam2d/edge_se2_xyprior.h:66-70``)."""
    (x,) = states
    return x[..., :2] - meas


EdgeSE2XYPrior = register_edge(EdgeType(
    name="EDGE_PRIOR_SE2_XY",
    vertex_types=(VertexSE2,),
    residual_dim=2,
    residual=_edge_se2_xy_prior_residual,
    meas_dim=2,
    tags=("EDGE_PRIOR_SE2_XY",),
))


def _edge_se2_xy_calib_residual(states, meas, param):
    """Landmark observation through an estimated sensor offset
    (``g2o/types/slam2d/edge_se2_pointxy_calib.h:46-52``)."""
    x, l, calib = states
    sensor = lie.se2_compose(x, calib)
    return lie.se2_act(lie.se2_inverse(sensor), l) - meas


EdgeSE2PointXYCalib = register_edge(EdgeType(
    name="EDGE_SE2_XY_CALIB",
    vertex_types=(VertexSE2, VertexPointXY, VertexSE2),
    residual_dim=2,
    residual=_edge_se2_xy_calib_residual,
    meas_dim=2,
    tags=("EDGE_SE2_XY_CALIB",),
))


def _edge_se2_offset_residual(states, meas, param):
    """Pose-pose constraint through per-end sensor offsets
    (``g2o/types/slam2d/edge_se2_offset.cpp:96-100``);
    params = [offset_from(3), offset_to(3)]."""
    xi, xj = states
    ni = lie.se2_compose(xi, param[..., :3])
    nj = lie.se2_compose(xj, param[..., 3:6])
    delta = lie.se2_compose(lie.se2_inverse(ni), nj)
    return lie.se2_compose(lie.se2_inverse(meas), delta)


EdgeSE2Offset = register_edge(EdgeType(
    name="EDGE_SE2_OFFSET",
    vertex_types=(VertexSE2, VertexSE2),
    residual_dim=3,
    residual=_edge_se2_offset_residual,
    meas_dim=3,
    param_dim=6,
    num_params=2,
    tags=("EDGE_SE2_OFFSET",),
))


def _edge_se2_xy_offset_residual(states, meas, param):
    """Landmark observation through a fixed sensor offset parameter
    (``g2o/types/slam2d/edge_se2_pointxy_offset.cpp:89-98``)."""
    x, l = states
    sensor = lie.se2_compose(x, param[..., :3])
    return lie.se2_act(lie.se2_inverse(sensor), l) - meas


EdgeSE2PointXYOffset = register_edge(EdgeType(
    name="EDGE_SE2_POINTXY_OFFSET",
    vertex_types=(VertexSE2, VertexPointXY),
    residual_dim=2,
    residual=_edge_se2_xy_offset_residual,
    meas_dim=2,
    param_dim=3,
    tags=("EDGE_SE2_POINTXY_OFFSET",),
))


_LOTS_OF_XY_CACHE: dict = {}


def make_edge_se2_lots_of_xy(k: int) -> EdgeType:
    """Variable-arity landmark edge (reference ``EdgeSE2LotsOfXY``,
    ``edge_se2_lotsofxy.h``): each observed-point count ``k`` gets its own
    (cached) edge type with measurement dim 2k, so edges of equal arity
    batch together like any other type."""
    et = _LOTS_OF_XY_CACHE.get(k)
    if et is not None:
        return et

    def residual(states, meas, param):
        inv = lie.se2_inverse(states[0])
        preds = [lie.se2_act(inv, p) for p in states[1:]]
        return torch.cat(preds, dim=-1) - meas

    et = register_edge(EdgeType(
        name=f"EDGE_SE2_LOTSOFXY_{k}",
        vertex_types=(VertexSE2,) + (VertexPointXY,) * k,
        residual_dim=2 * k,
        residual=residual,
        meas_dim=2 * k,
        tags=(f"EDGE_SE2_LOTSOFXY_{k}",),
        dynamic_tag="EDGE_SE2_LOTSOFXY",
    ))
    _LOTS_OF_XY_CACHE[k] = et
    return et


# variable-arity text lines 'EDGE_SE2_LOTSOFXY ids... || k meas info'
# (reference tag registration ``types_slam2d.cpp:53``)
REGISTRY.register_dynamic_edge("EDGE_SE2_LOTSOFXY", make_edge_se2_lots_of_xy)


def _edge_se2_two_points_residual(states, meas, param):
    """Two landmarks observed from one pose (reference
    ``EdgeSE2TwoPointsXY``, ``edge_se2_twopointsxy.cpp``): both points in
    the observing frame stacked into a 4-vector."""
    x, p1, p2 = states
    inv = lie.se2_inverse(x)
    return torch.cat([lie.se2_act(inv, p1), lie.se2_act(inv, p2)],
                     dim=-1) - meas


EdgeSE2TwoPointsXY = register_edge(EdgeType(
    name="EDGE_SE2_TWOPOINTSXY",
    vertex_types=(VertexSE2, VertexPointXY, VertexPointXY),
    residual_dim=4,
    residual=_edge_se2_two_points_residual,
    meas_dim=4,
    tags=("EDGE_SE2_TWOPOINTSXY",),
))
