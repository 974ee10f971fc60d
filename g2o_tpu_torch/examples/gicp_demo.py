"""GICP two-pose alignment — port of ``examples/gicp_demo.py``, the
analogue of the reference ``examples/icp/gicp_demo.cpp``: two SE3
vertices connected by many point-to-plane EDGE_V_V_GICP edges built from
matched noisy surface points with normals; recovers the relative
transform.

Run: python -m g2o_tpu_torch.examples.gicp_demo [point_noise] [-device cpu]
"""

import sys

import numpy as np

from g2o_tpu_torch.examples import split_device


def main(argv=None):
    device, args = split_device(argv)
    noise = float(args[0]) if len(args) > 0 else 0.01

    from g2o_tpu_torch.core.graph import Graph
    from g2o_tpu_torch.core.lm_fused import optimize_fused
    from g2o_tpu_torch.core.solvers import DenseSolver
    from g2o_tpu_torch.types.icp import (
        EdgeVVGicp, gicp_information, gicp_measurement,
    )
    from g2o_tpu_torch.types.slam3d import VertexSE3

    rng = np.random.default_rng(0)

    # ground truth: pose0 = identity, pose1 offset (as in the reference demo)
    t_true = np.array([0.3, -0.2, 0.1])
    ang = 0.15
    q_true = np.array([np.sin(ang / 2), 0.0, 0.0, np.cos(ang / 2)])

    g = Graph()
    g.add_vertex(0, VertexSE3, np.array([0, 0, 0, 0, 0, 0, 1.0]), fixed=True)
    # start pose1 at identity (wrong); the edges must pull it to the truth
    g.add_vertex(1, VertexSE3, np.array([0, 0, 0, 0, 0, 0, 1.0]))

    def rot(q, v):
        w, x = q[3], q[:3]
        return v + 2 * np.cross(x, np.cross(x, v) + w * v)

    n_pairs = 400
    for _ in range(n_pairs):
        p_w = rng.uniform(-2, 2, 3)
        nrm = rng.normal(size=3)
        nrm /= np.linalg.norm(nrm)
        # point as seen from pose0 (identity): p0 = p_w
        p0 = p_w + rng.normal(scale=noise, size=3)
        # pose1 true: X1 = (t, q); point in frame1: R^T (p - t)
        p1 = rot(np.concatenate([-q_true[:3], q_true[3:]]), p_w - t_true)
        p1 = p1 + rng.normal(scale=noise, size=3)
        meas = gicp_measurement(p0, nrm, p1, nrm)
        info = gicp_information(nrm, e=1e-3)
        g.add_edge(EdgeVVGicp, [0, 1], meas, info)

    p = g.compile(device=device)
    res = optimize_fused(p, DenseSolver(), 10)
    est = p.get_estimate(1)
    t_err = np.linalg.norm(est[:3] - t_true)
    q_err = 1.0 - abs(float(np.dot(est[3:7], q_true)))
    print(f"chi2 {res['chi2_per_iteration'][0]:.2f} -> {res['chi2_final']:.4f}"
          f"; translation error {t_err:.5f}, quaternion error {q_err:.2e}")
    assert t_err < 5 * noise + 1e-3
    return 0


if __name__ == "__main__":
    sys.exit(main())
