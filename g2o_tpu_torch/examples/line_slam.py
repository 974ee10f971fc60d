"""Line SLAM with Plücker lines — port of ``examples/line_slam.py``, the
analogue of the reference ``examples/line_slam/simulator_3d_line.cpp``: a
trajectory observes 3D lines (Plücker coordinates, 4-dof orthonormal
updates); EDGE_SE3_LINE3D measures each line in the sensor frame.

Run: python -m g2o_tpu_torch.examples.line_slam [-device cpu]
"""

import sys

import numpy as np
import torch

from g2o_tpu_torch.core.graph import Graph
from g2o_tpu_torch.core.optimizer import LevenbergMarquardt, SparseOptimizer
from g2o_tpu_torch.core.solvers import PCGSolver
from g2o_tpu_torch.examples import split_device
from g2o_tpu_torch.ops import lie
from g2o_tpu_torch.types.slam3d import EdgeSE3, VertexSE3
from g2o_tpu_torch.types.slam3d_addons import (
    EdgeSE3Line3D, VertexLine3D, line3d_ominus, line3d_oplus,
    line3d_transform,
)


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def pluecker_from_points(p, q):
    d = q - p
    d = d / np.linalg.norm(d)
    w = np.cross(p, d)
    return np.concatenate([w, d])


def main(argv=None):
    device, _ = split_device(argv)
    rng = np.random.default_rng(11)

    # world lines: edges of a room
    true_lines = np.stack([
        pluecker_from_points(np.array([5.0, -5.0, 0.0]),
                             np.array([5.0, 5.0, 0.0])),
        pluecker_from_points(np.array([5.0, 5.0, 0.0]),
                             np.array([5.0, 5.0, 3.0])),
        pluecker_from_points(np.array([-5.0, 5.0, 0.0]),
                             np.array([5.0, 5.0, 0.0])),
        pluecker_from_points(np.array([-5.0, -5.0, 2.5]),
                             np.array([5.0, -5.0, 2.5])),
    ])

    n_poses = 25
    poses = []
    for i in range(n_poses):
        th = 1.5 * np.pi * i / n_poses
        t = np.array([1.5 * np.cos(th), 1.5 * np.sin(th), 0.3])
        q = np.array([0, 0, np.sin(th / 4), np.cos(th / 4)])
        poses.append(np.concatenate([t, q]))

    g = Graph()
    info_line = np.eye(4) * 1e4
    info_odo = np.eye(6) * 1e4
    for i, x in enumerate(poses):
        noisy = x + (rng.normal(scale=0.03, size=7) if i else 0.0)
        noisy[3:] /= np.linalg.norm(noisy[3:])
        g.add_vertex(i, VertexSE3, noisy, fixed=(i == 0))
    for k, ln in enumerate(true_lines):
        init = line3d_oplus(_t(ln), _t(rng.normal(scale=0.02,
                                                   size=4))).numpy()
        g.add_vertex(100 + k, VertexLine3D, init)

    for i in range(1, n_poses):
        rel = lie.se3_compose(lie.se3_inverse(_t(poses[i - 1])),
                              _t(poses[i])).numpy()
        g.add_edge(EdgeSE3, [i - 1, i], rel, info_odo)

    for i, x in enumerate(poses):
        xinv = lie.se3_inverse(_t(x))
        for k, ln in enumerate(true_lines):
            local = line3d_transform(xinv, _t(ln))
            obs = line3d_oplus(local, _t(rng.normal(scale=0.002,
                                                    size=4))).numpy()
            g.add_edge(EdgeSE3Line3D, [i, 100 + k], obs, info_line)

    p = g.compile(device=device)
    opt = SparseOptimizer(p, algorithm=LevenbergMarquardt(),
                          solver=PCGSolver(max_iter=200), verbose=True)
    opt.optimize(15)

    for k, ln in enumerate(true_lines):
        est = p.get_estimate(100 + k)
        diff = line3d_ominus(_t(ln), _t(est)).numpy()
        print(f"line {k}: orthonormal-coordinate error "
              f"{np.linalg.norm(diff):.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
