"""Plane SLAM with sensor calibration — port of ``examples/plane_slam.py``,
the analogue of the reference ``examples/plane_slam/simulator_3d_plane.cpp``:
a robot trajectory observes world planes through a mounted sensor with an
unknown offset; the ternary EDGE_SE3_PLANE_CALIB couples pose x plane x
sensor-offset, recovering all three (the offset vertex is shared across
all observations).

Run: python -m g2o_tpu_torch.examples.plane_slam [-device cpu]
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
    EdgeSE3PlaneCalib, VertexPlane, plane_ominus, plane_oplus,
    plane_transform,
)


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def main(argv=None):
    device, _ = split_device(argv)
    rng = np.random.default_rng(3)

    # world planes: the floor and two walls (as in the reference simulator)
    true_planes = np.array([
        [0.0, 0.0, 1.0, 0.0],     # floor z=0
        [1.0, 0.0, 0.0, -5.0],    # wall x=5
        [0.0, 1.0, 0.0, -5.0],    # wall y=5
    ])

    # true sensor offset: small rotation + lever arm
    ang = 0.1
    off_true = np.array([0.2, 0.0, 0.1,
                         0.0, np.sin(ang / 2), 0.0, np.cos(ang / 2)])

    # circular trajectory with height + pitch variation (a yaw-only planar
    # path leaves the sensor offset unobservable along the vertical)
    n_poses = 40
    poses = []
    for i in range(n_poses):
        th = 2 * np.pi * i / n_poses
        t = np.array([2 * np.cos(th), 2 * np.sin(th),
                      0.5 + 0.4 * np.sin(2 * th)])
        qy = np.array([0, 0, np.sin(th / 2), np.cos(th / 2)])
        pitch = 0.25 * np.sin(3 * th)
        qp = np.array([0, np.sin(pitch / 2), 0, np.cos(pitch / 2)])
        w1, v1 = qy[3], qy[:3]
        w2, v2 = qp[3], qp[:3]
        q = np.concatenate([w1 * v2 + w2 * v1 + np.cross(v1, v2),
                            [w1 * w2 - np.dot(v1, v2)]])
        poses.append(np.concatenate([t, q / np.linalg.norm(q)]))

    g = Graph()
    plane_noise = np.array([0.005, 0.005, 0.01])
    info_plane = np.diag(1.0 / plane_noise ** 2)
    info_odo = np.eye(6) * 1e4

    for i, x in enumerate(poses):
        noisy = x + rng.normal(scale=0.05, size=7) if i else x
        noisy[3:] /= np.linalg.norm(noisy[3:])
        g.add_vertex(i, VertexSE3, noisy, fixed=(i == 0))
    for k, pl in enumerate(true_planes):
        init = pl + rng.normal(scale=0.05, size=4)
        init[:3] /= np.linalg.norm(init[:3])
        g.add_vertex(100 + k, VertexPlane, init)
    # sensor offset vertex, initialised at identity (unknown calibration)
    g.add_vertex(200, VertexSE3, np.array([0, 0, 0, 0, 0, 0, 1.0]))

    # odometry chain
    for i in range(1, n_poses):
        rel = lie.se3_compose(lie.se3_inverse(_t(poses[i - 1])),
                              _t(poses[i])).numpy()
        g.add_edge(EdgeSE3, [i - 1, i], rel, info_odo)

    # plane observations through the true offset
    for i, x in enumerate(poses):
        w2s = lie.se3_inverse(lie.se3_compose(_t(x), _t(off_true)))
        for k, pl in enumerate(true_planes):
            local = plane_transform(w2s, _t(pl))
            meas = plane_ominus(local, local).numpy()  # zero in min coords
            # perturb in minimal coordinates: azimuth/elevation/distance
            meas = meas + rng.normal(scale=plane_noise)
            # re-encode: observation = local plane perturbed
            obs = plane_oplus(local, _t(meas)).numpy()
            g.add_edge(EdgeSE3PlaneCalib, [i, 100 + k, 200], obs, info_plane)

    p = g.compile(device=device)
    opt = SparseOptimizer(p, algorithm=LevenbergMarquardt(),
                          solver=PCGSolver(max_iter=200), verbose=True)
    opt.optimize(30)

    off_est = p.get_estimate(200)
    t_err = np.linalg.norm(off_est[:3] - off_true[:3])
    q_err = 1 - abs(float(np.dot(off_est[3:], off_true[3:])))
    print(f"recovered sensor offset: translation error {t_err:.4f}, "
          f"quaternion error {q_err:.2e}")
    for k, pl in enumerate(true_planes):
        est = p.get_estimate(100 + k)
        if np.dot(est[:3], pl[:3]) < 0:
            est = -est
        print(f"plane {k}: |est - true| = {np.linalg.norm(est - pl):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
