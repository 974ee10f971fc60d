"""Differential-drive odometry calibration — port of
``examples/odom_calibration.py``, the analogue of the reference
``examples/calibration_odom_laser`` flow (simplified): given ground-truth
poses (e.g. from scan matching) and raw wheel velocities, estimate the
wheel factors and baseline with the sclam2d calibration edge.

Run: python -m g2o_tpu_torch.examples.odom_calibration [-device cpu]
"""

import numpy as np
import torch

from g2o_tpu_torch.core.graph import Graph
from g2o_tpu_torch.core.optimizer import LevenbergMarquardt, SparseOptimizer
from g2o_tpu_torch.core.solvers import DenseSolver
from g2o_tpu_torch.examples import split_device
from g2o_tpu_torch.ops import lie
from g2o_tpu_torch.types.sclam2d import (
    EdgeSE2OdomDifferentialCalib,
    VertexOdomDifferentialParams,
    velocity_to_motion,
)
from g2o_tpu_torch.types.slam2d import VertexSE2


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def main(argv=None):
    device, _ = split_device(argv)
    params_gt = np.array([0.96, 1.03, 0.55])   # k_left, k_right, baseline
    rng = np.random.default_rng(0)
    g = Graph()
    poses = [np.zeros(3)]
    meas = []
    for i in range(60):
        vl = 0.8 + 0.4 * rng.random()
        vr = 0.8 + 0.4 * rng.random()
        dt = 0.25
        motion = velocity_to_motion(
            _t(vl * params_gt[0]), _t(vr * params_gt[1]), _t(dt),
            _t(params_gt[2]))
        poses.append(lie.se2_compose(_t(poses[-1]), motion).numpy())
        meas.append((vl, vr, dt))
    for i, x in enumerate(poses):
        g.add_vertex(i, VertexSE2, x, fixed=True)  # poses known (laser gt)
    g.add_vertex(999, VertexOdomDifferentialParams, [1.0, 1.0, 0.5])
    for i, m in enumerate(meas):
        g.add_edge(EdgeSE2OdomDifferentialCalib, [i, i + 1, 999], m,
                   np.eye(3) * 10)
    p = g.compile(device=device)
    opt = SparseOptimizer(p, algorithm=LevenbergMarquardt(),
                          solver=DenseSolver())
    opt.optimize(50)
    est = p.get_estimate(999)
    print(f"truth:    k_l={params_gt[0]} k_r={params_gt[1]} b={params_gt[2]}")
    print(f"estimate: k_l={est[0]:.4f} k_r={est[1]:.4f} b={est[2]:.4f}")


if __name__ == "__main__":
    main()
