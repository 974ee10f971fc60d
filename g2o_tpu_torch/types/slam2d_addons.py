"""Segment and line 2D SLAM types — port of
``g2o_tpu/types/slam2d_addons.py`` (the reference library is
``g2o/types/slam2d_addons``).

* ``VERTEX_SEGMENT2D``: two endpoints (p1x p1y p2x p2y), additive update
  (``vertex_segment2d.h:82-86``).
* ``VERTEX_LINE2D``: (theta, rho, p1Id, p2Id), additive on (theta, rho)
  with the angle wrapped (``vertex_line2d.h:86-90``); the endpoint ids
  ride along un-updated.
* ``EDGE_SE2_SEGMENT2D``: both endpoints in the observing pose frame
  (``edge_se2_segment2d.h:49-59``); ``_LINE``: the segment's supporting
  line (theta, rho); ``_POINTLINE`` (and ``_POINTLINE_P1`` for the second
  endpoint): one endpoint and the line direction.
* ``EDGE_SE2_LINE2D``: a line observed from a pose
  (``edge_se2_line2d.h:45-57``); ``EDGE_LINE2D``: line-line difference;
  ``EDGE_LINE2D_POINTXY``: the point-on-line error.
"""

from __future__ import annotations

import torch

from g2o_tpu_torch.core.types import (EdgeType, VertexType, register_edge,
                                      register_vertex)
from g2o_tpu_torch.ops import lie
from g2o_tpu_torch.types.slam2d import VertexPointXY, VertexSE2


def _segment_oplus(x, d):
    return x + d


VertexSegment2D = register_vertex(VertexType(
    name="VERTEX_SEGMENT2D",
    rep_dim=4,
    tangent_dim=4,
    oplus=_segment_oplus,
    tags=("VERTEX_SEGMENT2D",),
))


def _line2d_oplus(x, d):
    return torch.cat([
        torch.stack([lie.normalize_angle(x[..., 0] + d[..., 0]),
                     x[..., 1] + d[..., 1]], dim=-1),
        x[..., 2:4]], dim=-1)


VertexLine2D = register_vertex(VertexType(
    name="VERTEX_LINE2D",
    # (theta, rho) and the reference's serialized p1Id/p2Id endpoint ids
    # (``slam2d_addons/vertex_line2d.cpp:52-58``); -1 = unassigned
    rep_dim=4,
    tangent_dim=2,
    oplus=_line2d_oplus,
    tags=("VERTEX_LINE2D",),
))


def _edge_se2_segment2d_residual(states, meas, param):
    x, seg = states
    inv = lie.se2_inverse(x)
    e1 = lie.se2_act(inv, seg[..., 0:2])
    e2 = lie.se2_act(inv, seg[..., 2:4])
    return torch.cat([e1, e2], dim=-1) - meas


EdgeSE2Segment2D = register_edge(EdgeType(
    name="EDGE_SE2_SEGMENT2D",
    vertex_types=(VertexSE2, VertexSegment2D),
    residual_dim=4,
    residual=_edge_se2_segment2d_residual,
    meas_dim=4,
    tags=("EDGE_SE2_SEGMENT2D",),
))


def _segment_line_frame(x, seg):
    """The observed endpoints and the supporting line (theta, rho)."""
    inv = lie.se2_inverse(x)
    p1 = lie.se2_act(inv, seg[..., 0:2])
    p2 = lie.se2_act(inv, seg[..., 2:4])
    dp = p2 - p1
    n = torch.stack([dp[..., 1], -dp[..., 0]], dim=-1)
    n = n / torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True))
    theta = torch.atan2(n[..., 1], n[..., 0])
    rho = 0.5 * (torch.sum(p1 * n, dim=-1) + torch.sum(p2 * n, dim=-1))
    return p1, p2, theta, rho


def _edge_se2_segment2d_line_residual(states, meas, param):
    """The segment observed as its supporting line
    (``edge_se2_segment2d_line.h:51-65``)."""
    x, seg = states
    _, _, theta, rho = _segment_line_frame(x, seg)
    e_theta = lie.normalize_angle(theta - meas[..., 0])
    return torch.stack([e_theta, rho - meas[..., 1]], dim=-1)


EdgeSE2Segment2DLine = register_edge(EdgeType(
    name="EDGE_SE2_SEGMENT2D_LINE",
    vertex_types=(VertexSE2, VertexSegment2D),
    residual_dim=2,
    residual=_edge_se2_segment2d_line_residual,
    meas_dim=2,
    tags=("EDGE_SE2_SEGMENT2D_LINE",),
))


def _make_segment2d_pointline(point_num: int):
    def residual(states, meas, param):
        """One endpoint and the supporting-line direction
        (``edge_se2_segment2d_pointLine.h:53-68``)."""
        x, seg = states
        p1, p2, theta, _ = _segment_line_frame(x, seg)
        pt = p1 if point_num == 0 else p2
        e_theta = lie.normalize_angle(theta - meas[..., 2])
        return torch.cat([pt - meas[..., 0:2], e_theta[..., None]], dim=-1)

    return residual


EdgeSE2Segment2DPointLine = register_edge(EdgeType(
    name="EDGE_SE2_SEGMENT2D_POINTLINE",
    vertex_types=(VertexSE2, VertexSegment2D),
    residual_dim=3,
    residual=_make_segment2d_pointline(0),
    meas_dim=3,
    tags=("EDGE_SE2_SEGMENT2D_POINTLINE",),
))

# the reference picks the endpoint with a per-edge _pointNum member; the
# second endpoint has its own registered type
EdgeSE2Segment2DPointLine1 = register_edge(EdgeType(
    name="EDGE_SE2_SEGMENT2D_POINTLINE_P1",
    vertex_types=(VertexSE2, VertexSegment2D),
    residual_dim=3,
    residual=_make_segment2d_pointline(1),
    meas_dim=3,
    tags=("EDGE_SE2_SEGMENT2D_POINTLINE_P1",),
))


def _edge_se2_line2d_residual(states, meas, param):
    x, line = states
    inv = lie.se2_inverse(x)
    theta = lie.normalize_angle(line[..., 0] + inv[..., 2])
    n = torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)
    rho = line[..., 1] + torch.sum(n * inv[..., :2], dim=-1)
    err_theta = lie.normalize_angle(theta - meas[..., 0])
    return torch.stack([err_theta, rho - meas[..., 1]], dim=-1)


EdgeSE2Line2D = register_edge(EdgeType(
    name="EDGE_SE2_LINE2D",
    vertex_types=(VertexSE2, VertexLine2D),
    residual_dim=2,
    residual=_edge_se2_line2d_residual,
    meas_dim=2,
    tags=("EDGE_SE2_LINE2D",),
))


def _edge_line2d_residual(states, meas, param):
    l1, l2 = states
    return (l2[..., :2] - l1[..., :2]) - meas


EdgeLine2D = register_edge(EdgeType(
    name="EDGE_LINE2D",
    vertex_types=(VertexLine2D, VertexLine2D),
    residual_dim=2,
    residual=_edge_line2d_residual,
    meas_dim=2,
    tags=("EDGE_LINE2D",),
))


def _edge_line2d_pointxy_residual(states, meas, param):
    """Point-on-line error n(theta)·p - rho - z
    (``slam2d_addons/edge_line2d_pointxy.h:48-52``)."""
    l, p = states
    theta, rho = l[..., 0], l[..., 1]
    pred = (torch.cos(theta) * p[..., 0] + torch.sin(theta) * p[..., 1]) - rho
    return (pred - meas[..., 0])[..., None]


EdgeLine2DPointXY = register_edge(EdgeType(
    name="EDGE_LINE2D_POINTXY",
    vertex_types=(VertexLine2D, VertexPointXY),
    residual_dim=1,
    residual=_edge_line2d_pointxy_residual,
    meas_dim=1,
    tags=("EDGE_LINE2D_POINTXY",),
))
