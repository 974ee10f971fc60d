"""Sensor-calibration 2D SLAM types — port of ``g2o_tpu/types/sclam2d.py``
(the reference library is ``g2o/types/sclam2d``).

* ``EDGE_SE2_CALIB`` (EdgeSE2SensorCalib): a 3-ary edge estimating the
  laser offset with the trajectory; error =
  ``(Z^-1 ((x1 O)^-1 x2 O)).toVector()`` (``edge_se2_sensor_calib.h:45-54``).
* ``VERTEX_ODOM_DIFFERENTIAL``: the calibration (k_l, k_r, baseline).
* ``EDGE_SE2_ODOM_DIFFERENTIAL_CALIB``: differential-drive odometry
  calibration; the measurement is a (vl, vr, dt) velocity triple, turned
  into a motion by the ICC construction (``odometry_measurement.cpp:95-117``)
  and compared with the relative motion
  (``edge_se2_odom_differential_calib.h:45-63``).
"""

from __future__ import annotations

import torch

from g2o_tpu_torch.core.types import (EdgeType, VertexType, register_edge,
                                      register_vertex)
from g2o_tpu_torch.ops import lie
from g2o_tpu_torch.types.slam2d import VertexSE2


def _params_oplus(x, d):
    return x + d


# reference tag registration ``types/sclam2d/types_sclam2d.cpp:43``; the
# older spelling stays a read alias
VertexOdomDifferentialParams = register_vertex(VertexType(
    name="VERTEX_ODOM_DIFFERENTIAL",
    rep_dim=3,
    tangent_dim=3,
    oplus=_params_oplus,
    tags=("VERTEX_ODOM_DIFFERENTIAL", "VERTEX_ODOM_DIFF_PARAMS"),
))


def _edge_se2_sensor_calib_residual(states, meas, param):
    x1, x2, offset = states
    a = lie.se2_compose(x1, offset)
    b = lie.se2_compose(x2, offset)
    delta = lie.se2_compose(lie.se2_inverse(a), b)
    return lie.se2_compose(lie.se2_inverse(meas), delta)


EdgeSE2SensorCalib = register_edge(EdgeType(
    name="EDGE_SE2_CALIB",
    vertex_types=(VertexSE2, VertexSE2, VertexSE2),
    residual_dim=3,
    residual=_edge_se2_sensor_calib_residual,
    meas_dim=3,
    tags=("EDGE_SE2_CALIB",),
))


def velocity_to_motion(vl, vr, dt, baseline):
    """ICC differential-drive forward model
    (``odometry_measurement.cpp:95-117``).  Straight motion (|vr - vl| <
    1e-7) takes its own branch; the arc branch divides by a guarded
    difference (double ``where``), so neither branch's derivative is NaN."""
    diff = vr - vl
    straight = torch.abs(diff) < 1e-7
    safe_diff = torch.where(straight, 1.0, diff)
    R = baseline * 0.5 * (vl + vr) / safe_diff
    w = safe_diff / baseline
    theta = w * dt
    c, s = torch.cos(theta), torch.sin(theta)
    # motion = rot(theta) * (-icc) + icc, icc = (0, R)
    x_arc = s * R
    y_arc = -c * R + R
    tv = 0.5 * (vr + vl)
    x = torch.where(straight, tv * dt, x_arc)
    y = torch.where(straight, 0.0, y_arc)
    th = torch.where(straight, 0.0, theta)
    return torch.stack([x, y, th], dim=-1)


def _edge_se2_odom_diff_calib_residual(states, meas, param):
    x1, x2, params = states
    vl, vr, dt = meas[..., 0], meas[..., 1], meas[..., 2]
    motion = velocity_to_motion(vl * params[..., 0], vr * params[..., 1],
                                dt, params[..., 2])
    delta = lie.se2_compose(lie.se2_inverse(x1), x2)
    return lie.se2_compose(lie.se2_inverse(motion), delta)


# reference tag registration ``types/sclam2d/types_sclam2d.cpp:45``
EdgeSE2OdomDifferentialCalib = register_edge(EdgeType(
    name="EDGE_SE2_ODOM_DIFFERENTIAL_CALIB",
    vertex_types=(VertexSE2, VertexSE2, VertexOdomDifferentialParams),
    residual_dim=3,
    residual=_edge_se2_odom_diff_calib_residual,
    meas_dim=3,
    tags=("EDGE_SE2_ODOM_DIFFERENTIAL_CALIB", "EDGE_SE2_ODOM_DIFF_CALIB"),
))
