"""Anchored inverse-depth bundle adjustment — port of
``examples/ba_anchored_inverse_depth.py``, the analogue of the reference
``examples/ba_anchored_inverse_depth/ba_anchored_inverse_depth_demo.cpp``:
points are parameterised as psi = (u, v, rho) in their *anchor* camera's
frame; the 3-ary EDGE_PROJECT_PSI2UV:EXPMAP couples (point, observing
camera, anchor camera), which conditions depth uncertainty much better for
far points.

Run: python -m g2o_tpu_torch.examples.ba_anchored_inverse_depth
     [pixel_noise] [-device cpu]
"""

import sys

import numpy as np
import torch

from g2o_tpu_torch.examples import split_device


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def main(argv=None):
    device, args = split_device(argv)
    pixel_noise = float(args[0]) if len(args) > 0 else 1.0

    from g2o_tpu_torch.core.graph import Graph
    from g2o_tpu_torch.core.lm_fused import optimize_fused
    from g2o_tpu_torch.core.solvers.schur_implicit import ImplicitSchurSolver
    from g2o_tpu_torch.ops import lie
    from g2o_tpu_torch.types.sba import (
        CAM_PARAM_ID, EdgeProjectPSI2UV, VertexPointXYZ, VertexSE3Expmap,
    )

    rng = np.random.default_rng(0)
    focal, cx, cy = 1000.0, 320.0, 240.0
    n_cams, n_points = 15, 300

    true_points = np.stack([
        rng.uniform(-3, 3, n_points),
        rng.uniform(-0.5, 0.5, n_points),
        rng.uniform(4, 8, n_points),
    ], axis=1)

    g = Graph()
    g.add_parameter(CAM_PARAM_ID, np.array([focal, cx, cy, 0.0]))
    cams = []
    for i in range(n_cams):
        trans = np.array([i * 0.04 - 1.0, 0.0, 0.0])
        Tcw = np.concatenate([-trans, [0, 0, 0, 1.0]])  # R = I
        cams.append(Tcw)
        g.add_vertex(i, VertexSE3Expmap, Tcw, fixed=(i < 2))

    def project(Tcw, pw):
        pc = pw + Tcw[:3]
        return np.array([focal * pc[0] / pc[2] + cx,
                         focal * pc[1] / pc[2] + cy]), pc[2]

    vid = n_cams
    truth = {}
    for k in range(n_points):
        vis = []
        for i in range(n_cams):
            uv, z = project(cams[i], true_points[k])
            if z > 0 and 0 <= uv[0] < 2 * cx and 0 <= uv[1] < 2 * cy:
                vis.append((i, uv))
        if len(vis) < 2:
            continue
        anchor = vis[0][0]
        # psi in the anchor frame from a NOISY world point
        noisy = true_points[k] + rng.normal(scale=1.0, size=3)
        pa = lie.se3_act(_t(cams[anchor]), _t(noisy)).numpy()
        psi = np.array([pa[0] / pa[2], pa[1] / pa[2], 1.0 / pa[2]])
        g.add_vertex(vid, VertexPointXYZ, psi, marginalized=True)
        truth[vid] = (anchor, true_points[k])
        for i, uv in vis:
            obs = uv + rng.normal(scale=pixel_noise, size=2)
            g.add_edge(EdgeProjectPSI2UV, [vid, i, anchor], obs, np.eye(2),
                       param_id=CAM_PARAM_ID)
        vid += 1

    p = g.compile(device=device)
    # the marginalized psi points ride the general implicit-Schur path
    # (3-ary PSI2UV edges: both camera slots couple through per-slot B
    # blocks — the reference Schur-marginalizes these the same way,
    # block_solver.hpp:224-253)
    res = optimize_fused(p, ImplicitSchurSolver(max_iter=150, tol=1e-8), 15)

    # recover world points: X = T_anchor^-1 * (u, v, 1)/rho
    errs = []
    for v, (anchor, pw) in truth.items():
        psi = p.get_estimate(v)
        pc = np.array([psi[0], psi[1], 1.0]) / psi[2]
        est = lie.se3_act(lie.se3_inverse(_t(p.get_estimate(anchor))),
                          _t(pc)).numpy()
        errs.append(np.linalg.norm(est - pw))
    print(f"chi2 {res['chi2_per_iteration'][0]:.1f} -> "
          f"{res['chi2_final']:.2f}; median world-point error "
          f"{np.median(errs):.4f} over {len(errs)} anchored points")
    return 0


if __name__ == "__main__":
    sys.exit(main())
