"""Plane, line, calibration and Euler-serialized SE3 types — port of
``g2o_tpu/types/slam3d_addons.py`` (the reference library is
``g2o/types/slam3d_addons``).

* ``VERTEX_PLANE``: normalized coefficients (nx, ny, nz, -d)
  (``plane3d.h:54-117``); the update rotates the normal by
  azimuth/elevation increments in the plane's own frame and adds to the
  distance (``plane3d.h:88-101``).
* ``VERTEX_LINE3D``: Plücker coordinates (w, d), |d| = 1, with the 4-dof
  orthonormal update (U in SO(3), W in SO(2), ``line3d.h:148-163``).
* ``EDGE_SE3_LINE3D``, ``EDGE_PLANE``, the 3-ary ``EDGE_SE3_PLANE_CALIB``
  and ``EDGE_SE3_CALIB``.
* ``VERTEX3`` / ``EDGE3``: the SE3 state and MQT error of
  ``VERTEX_SE3:QUAT`` / ``EDGE_SE3:QUAT``, written as [t, roll, pitch,
  yaw] with the information matrix in Euler coordinates
  (``vertex_se3_euler.cpp:38-55``, ``edge_se3_euler.cpp:58-104``).  The
  Euler conversions and their Jacobian are host-side numpy.

Norms are ``sqrt(sum(x * x))``, as ``jnp.linalg.norm`` computes them: the
derivative at a zero vector is NaN in both packages (a vertical plane
normal in ``_elevation``, a line through the origin in
``_line_to_orthonormal``), where ``torch.linalg.vector_norm`` would give 0.
"""

from __future__ import annotations

import numpy as np
import torch

from g2o_tpu_torch.core.types import (EdgeType, VertexType, register_edge,
                                      register_vertex)
from g2o_tpu_torch.ops import lie
from g2o_tpu_torch.types.slam3d import VertexSE3


def _norm(v, keepdim=False):
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=keepdim))


def _azimuth(v):
    return torch.atan2(v[..., 1], v[..., 0])


def _elevation(v):
    return torch.atan2(v[..., 2], _norm(v[..., :2]))


def _plane_normalize(c):
    return c / _norm(c[..., :3], keepdim=True)


def _rotation_of_normal(n):
    """R = Rz(azimuth) * Ry(-elevation) (``plane3d.h:82-86``)."""
    az, el = _azimuth(n), _elevation(n)
    ca, sa = torch.cos(az), torch.sin(az)
    ce, se = torch.cos(el), torch.sin(el)
    return torch.stack([
        torch.stack([ca * ce, -sa, -ca * se], dim=-1),
        torch.stack([sa * ce, ca, -sa * se], dim=-1),
        torch.stack([se, torch.zeros_like(ca), ce], dim=-1),
    ], dim=-2)


def plane_oplus(c, v):
    az, el, dd = v[..., 0], v[..., 1], v[..., 2]
    s, co = torch.sin(el), torch.cos(el)
    n_local = torch.stack([co * torch.cos(az), co * torch.sin(az), s], dim=-1)
    R = _rotation_of_normal(c[..., :3])
    n_new = torch.einsum("...ij,...j->...i", R, n_local)
    d = -c[..., 3] + dd
    return _plane_normalize(torch.cat([n_new, -d[..., None]], dim=-1))


def plane_ominus(ref, plane):
    """[azimuth, elevation, distance] of ``plane`` in ``ref``'s frame
    (``plane3d.h:103-110``)."""
    R = _rotation_of_normal(ref[..., :3])
    n = torch.einsum("...ji,...j->...i", R, plane[..., :3])     # R^T n
    d = (-ref[..., 3]) - (-plane[..., 3])
    return torch.stack([_azimuth(n), _elevation(n), d], dim=-1)


def plane_transform(x_se3, c):
    """T * plane for an SE3 state: n' = R n, w' = w - t . n'
    (``plane3d.h:121-128``)."""
    n = lie.quat_rotate(x_se3[..., 3:7], c[..., :3])
    w = c[..., 3] - torch.sum(x_se3[..., :3] * n, dim=-1)
    return _plane_normalize(torch.cat([n, w[..., None]], dim=-1))


VertexPlane = register_vertex(VertexType(
    name="VERTEX_PLANE",
    rep_dim=4,
    tangent_dim=3,
    oplus=plane_oplus,
    tags=("VERTEX_PLANE",),
))


# --------------------------------------------------------------------- #
# Plücker lines (reference ``line3d.h``)
# --------------------------------------------------------------------- #

_EPS = 1e-12


def _line_to_orthonormal(l):
    w, d = l[..., :3], l[..., 3:6]
    nw = _norm(w)
    nd = _norm(d)
    mag = torch.sqrt(nw * nw + nd * nd)
    W = torch.stack([
        torch.stack([nw / mag, -nd / mag], dim=-1),
        torch.stack([nd / mag, nw / mag], dim=-1),
    ], dim=-2)
    u0 = w / torch.clamp_min(nw, _EPS)[..., None]
    u1 = d / torch.clamp_min(nd, _EPS)[..., None]
    cr = torch.linalg.cross(w, d, dim=-1)
    u2 = cr / torch.clamp_min(_norm(cr), _EPS)[..., None]
    U = torch.stack([u0, u1, u2], dim=-1)   # columns
    return U, W


def _line_normalize(l):
    return l / torch.clamp_min(_norm(l[..., 3:6], keepdim=True), _EPS)


def _line_from_orthonormal(U, W):
    w = U[..., :, 0] * W[..., 0, 0][..., None]
    d = U[..., :, 1] * W[..., 1, 0][..., None]
    return _line_normalize(torch.cat([w, d], dim=-1))


def line3d_oplus(l, v):
    """Orthonormal update (``line3d.h:148-163``): U <- U R(quat(v[:3])),
    W <- W Rot2(v[3])."""
    U, W = _line_to_orthonormal(l)
    R = lie.quat_to_matrix(lie.quat_from_compact(v[..., :3]))
    c, s = torch.cos(v[..., 3]), torch.sin(v[..., 3])
    W2 = torch.stack([torch.stack([c, -s], dim=-1),
                      torch.stack([s, c], dim=-1)], dim=-2)
    return _line_from_orthonormal(U @ R, W @ W2)


def line3d_ominus(a, b):
    """4-dof difference (``line3d.h:165-181``): the quaternion vector of
    U_a^T U_b and the SO(2) angle of W_a^T W_b."""
    Ua, Wa = _line_to_orthonormal(a)
    Ub, Wb = _line_to_orthonormal(b)
    dU = Ua.transpose(-1, -2) @ Ub
    dW = Wa.transpose(-1, -2) @ Wb
    q = lie.quat_from_matrix(dU)
    ang = torch.atan2(dW[..., 1, 0], dW[..., 0, 0])
    return torch.cat([q[..., :3], ang[..., None]], dim=-1)


def line3d_transform(x_se3, l):
    """T * line (Plücker): d' = R d, w' = R w + t x (R d)."""
    R_d = lie.quat_rotate(x_se3[..., 3:7], l[..., 3:6])
    R_w = lie.quat_rotate(x_se3[..., 3:7], l[..., :3])
    w = R_w + torch.linalg.cross(x_se3[..., :3], R_d, dim=-1)
    return _line_normalize(torch.cat([w, R_d], dim=-1))


VertexLine3D = register_vertex(VertexType(
    name="VERTEX_LINE3D",
    rep_dim=6,
    tangent_dim=4,
    oplus=line3d_oplus,
    tags=("VERTEX_LINE3D",),
))


def _edge_se3_line3d_residual(states, meas, param):
    """Reference ``EdgeSE3Line3D::computeError``
    (``edge_se3_line.cpp:73-79``): local = X^-1 * line, error =
    local.ominus(z)."""
    x, line = states
    local = line3d_transform(lie.se3_inverse(x), line)
    return line3d_ominus(local, meas)


EdgeSE3Line3D = register_edge(EdgeType(
    name="EDGE_SE3_LINE3D",
    vertex_types=(VertexSE3, VertexLine3D),
    residual_dim=4,
    residual=_edge_se3_line3d_residual,
    meas_dim=6,
    tags=("EDGE_SE3_LINE3D",),
))


def _edge_plane_residual(states, meas, param):
    """Plane-plane constraint (``edge_plane.h:44-49``): (p2 - p1) - z."""
    p1, p2 = states
    return (p2 - p1) - meas


EdgePlane = register_edge(EdgeType(
    name="EDGE_PLANE",
    vertex_types=(VertexPlane, VertexPlane),
    residual_dim=4,
    residual=_edge_plane_residual,
    meas_dim=4,
    tags=("EDGE_PLANE",),
))


def _edge_se3_plane_calib_residual(states, meas, param):
    """Reference ``EdgeSE3PlaneSensorCalib::computeError``
    (``edge_se3_plane_calib.h:46-56``): local = (X O)^-1 * plane, error =
    local.ominus(z)."""
    x, plane, offset = states
    w2n = lie.se3_inverse(lie.se3_compose(x, offset))
    return plane_ominus(plane_transform(w2n, plane), meas)


EdgeSE3PlaneCalib = register_edge(EdgeType(
    name="EDGE_SE3_PLANE_CALIB",
    vertex_types=(VertexSE3, VertexPlane, VertexSE3),
    residual_dim=3,
    residual=_edge_se3_plane_calib_residual,
    meas_dim=4,
    tags=("EDGE_SE3_PLANE_CALIB",),
))


def _edge_se3_calib_residual(states, meas, param):
    """Reference ``EdgeSE3Calib::computeError``
    (``slam3d_addons/edge_se3_calib.cpp:40-46``): error =
    toVectorMQT(Z^-1 C^-1 X1^-1 X2 C)."""
    x1, x2, calib = states
    delta = lie.se3_compose(
        lie.se3_compose(lie.se3_inverse(calib),
                        lie.se3_compose(lie.se3_inverse(x1), x2)),
        calib)
    return lie.se3_to_mqt(lie.se3_compose(lie.se3_inverse(meas), delta))


EdgeSE3Calib = register_edge(EdgeType(
    name="EDGE_SE3_CALIB",
    vertex_types=(VertexSE3, VertexSE3, VertexSE3),
    residual_dim=6,
    residual=_edge_se3_calib_residual,
    meas_dim=7,
    tags=("EDGE_SE3_CALIB",),
))


# ---- Euler-serialized SE3 (VERTEX3 / EDGE3) ------------------------------
# tags ``types_slam3d_addons.cpp:38-39``; host-side numpy throughout

def euler_to_quat(rpy):
    """RPY -> quaternion (x, y, z, w) (``isometry3d_mappings.cpp:60-75``)."""
    r, p, y = rpy
    sr, cr = np.sin(r / 2), np.cos(r / 2)
    sp, cp = np.sin(p / 2), np.cos(p / 2)
    sy, cy = np.sin(y / 2), np.cos(y / 2)
    return np.array([
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy,
    ])


def quat_to_euler(q):
    """Quaternion (x, y, z, w) -> RPY (``isometry3d_mappings.cpp:48-58``)."""
    q1, q2, q3, q0 = q
    roll = np.arctan2(2 * (q0 * q1 + q2 * q3), 1 - 2 * (q1 * q1 + q2 * q2))
    pitch = np.arcsin(np.clip(2 * (q0 * q2 - q3 * q1), -1.0, 1.0))
    yaw = np.arctan2(2 * (q0 * q3 + q1 * q2), 1 - 2 * (q2 * q2 + q3 * q3))
    return np.array([roll, pitch, yaw])


def et_to_qt(v6):
    """[t, rpy] -> [t, quat-xyzw] (``fromVectorET``)."""
    v6 = np.asarray(v6, dtype=float)
    return np.concatenate([v6[:3], euler_to_quat(v6[3:6])])


def qt_to_et(x7):
    """[t, quat-xyzw] -> [t, rpy] (``toVectorET``)."""
    x7 = np.asarray(x7, dtype=float)
    q = x7[3:7] / np.linalg.norm(x7[3:7])
    return np.concatenate([x7[:3], quat_to_euler(q)])


def _jac_qt_euler(x7, delta=1e-6):
    """Central-difference 6x6 Jacobian d(ET)/d(QT[0:6]) at the measurement:
    the intended ``jac_quat3_euler3`` (``edge_se3_euler.cpp:37-55``, whose
    loop writes every column into ``J.col(3)``, an upstream bug not
    reproduced)."""
    x7 = np.asarray(x7, dtype=float)
    J = np.zeros((6, 6))
    for i in range(6):
        ta, tb = x7.copy(), x7.copy()
        ta[i] -= delta
        tb[i] += delta
        J[:, i] = (qt_to_et(tb) - qt_to_et(ta)) / (2 * delta)
    return J


def _edge3_info_from_io(info_euler, meas7):
    J = _jac_qt_euler(meas7)
    return J.T @ np.asarray(info_euler) @ J


def _edge3_info_to_io(info_qt, meas7):
    J = np.linalg.inv(_jac_qt_euler(meas7))
    return J.T @ np.asarray(info_qt) @ J


VertexSE3Euler = register_vertex(VertexType(
    name="VERTEX3",
    rep_dim=7,
    tangent_dim=6,
    oplus=VertexSE3.oplus,
    to_vector=qt_to_et,
    from_vector=et_to_qt,
    io_dim=6,
    tags=("VERTEX3",),
))


def _edge3_residual(states, meas, param):
    xi, xj = states
    delta = lie.se3_compose(lie.se3_inverse(xi), xj)
    return lie.se3_to_mqt(lie.se3_compose(lie.se3_inverse(meas), delta))


EdgeSE3Euler = register_edge(EdgeType(
    name="EDGE3",
    vertex_types=(VertexSE3Euler, VertexSE3Euler),
    residual_dim=6,
    residual=_edge3_residual,
    meas_dim=7,
    meas_to_vector=qt_to_et,
    meas_from_vector=et_to_qt,
    meas_io_dim=6,
    info_from_io=_edge3_info_from_io,
    info_to_io=_edge3_info_to_io,
    tags=("EDGE3",),
))
