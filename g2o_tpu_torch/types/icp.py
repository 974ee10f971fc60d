"""GICP types — port of ``g2o_tpu/types/icp.py`` (the reference is
``g2o/types/icp/types_icp.h``).

``EDGE_V_V_GICP`` connects two SE3 poses through a pair of corresponding
surface points with normals: error = ``T0^-1 (T1 p1) - p0``
(``Edge_V_V_GICP::computeError``).  The measurement packs ``[pos0(3),
normal0(3), pos1(3), normal1(3)]``.  The point-to-plane behaviour comes
from the information matrix built from the normal's frame,
:func:`gicp_information` (``types_icp.h:111-150``), host-side numpy.
"""

from __future__ import annotations

import numpy as np

from g2o_tpu_torch.core.types import EdgeType, register_edge
from g2o_tpu_torch.ops import lie
from g2o_tpu_torch.types.slam3d import VertexSE3


def _edge_gicp_residual(states, meas, param):
    t0, t1 = states
    p1w = lie.se3_act(t1, meas[..., 6:9])
    return lie.se3_act(lie.se3_inverse(t0), p1w) - meas[..., 0:3]


EdgeVVGicp = register_edge(EdgeType(
    name="EDGE_V_V_GICP",
    vertex_types=(VertexSE3, VertexSE3),
    residual_dim=3,
    residual=_edge_gicp_residual,
    meas_dim=12,
    tags=("EDGE_V_V_GICP",),
))


def _make_rot(normal):
    """The rotation with the normal as its third row (reference
    ``makeRot0``, ``types_icp.h:84-96``)."""
    n = np.asarray(normal, dtype=float)
    n = n / np.linalg.norm(n)
    y = np.array([0.0, 1.0, 0.0]) - n[1] * n
    ny = np.linalg.norm(y)
    if ny < 1e-8:  # normal parallel to y
        y = np.array([1.0, 0.0, 0.0]) - n[0] * n
        ny = np.linalg.norm(y)
    y = y / ny
    x = np.cross(n, y)
    return np.stack([x, y, n])


def gicp_information(normal0, e: float = 1e-3, plane_plane_normal1=None,
                     e2: float | None = None):
    """Point-to-plane precision ``R0^T diag(e, e, 1) R0``; with
    ``plane_plane_normal1`` the plane-to-plane (GICP) form
    ``(cov0 + cov1)^-1``, ``cov = R^T diag(1, 1, e) R``."""
    R0 = _make_rot(normal0)
    if plane_plane_normal1 is None:
        return R0.T @ np.diag([e, e, 1.0]) @ R0
    e2 = e if e2 is None else e2
    R1 = _make_rot(plane_plane_normal1)
    cov0 = R0.T @ np.diag([1.0, 1.0, e]) @ R0
    cov1 = R1.T @ np.diag([1.0, 1.0, e2]) @ R1
    return np.linalg.inv(cov0 + cov1)


def gicp_measurement(pos0, normal0, pos1, normal1):
    return np.concatenate([np.asarray(pos0, float), np.asarray(normal0, float),
                           np.asarray(pos1, float), np.asarray(normal1, float)])
