"""3D SLAM types — port of the SE3 and point part of
``g2o_tpu/types/slam3d.py`` (``VERTEX_SE3:QUAT``, ``VERTEX_TRACKXYZ``,
``EDGE_SE3:QUAT``, ``EDGE_SE3_PRIOR``).

* ``VERTEX_SE3:QUAT``: state (tx, ty, tz, qx, qy, qz, qw); update is a
  right multiplication by ``fromVectorMQT(delta)``
  (``g2o/types/slam3d/vertex_se3.h:105-114``).
* ``VERTEX_TRACKXYZ``: a 3D point with an additive update (also the BAL
  landmark).
* ``EDGE_SE3:QUAT``: error = ``toVectorMQT(Z^-1 Xi^-1 Xj)``
  (``g2o/types/slam3d/edge_se3.cpp:77-82``).
* ``EDGE_SE3_PRIOR``: error = ``toVectorMQT(Z^-1 (X O))`` with the sensor
  offset O from ``PARAMS_SE3OFFSET`` (``edge_se3_prior.cpp``).
"""

from __future__ import annotations

from g2o_tpu_torch.core.types import (EdgeType, VertexType, register_edge,
                                      register_vertex)
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
