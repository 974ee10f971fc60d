"""Classic SBA demo — port of ``examples/sba_demo.py``, the analogue of
the reference ``examples/sba/sba_demo.cpp``:
a two-row camera rig (VERTEX_CAM, the SBACam model with intrinsics+baseline
in the state) observing a point grid through mono (EDGE_PROJECT_P2MC) or
stereo (EDGE_PROJECT_P2SC) projections, with noisy point initialisation.

Run: python -m g2o_tpu_torch.examples.sba_demo [pixel_noise] [mono|stereo]
     [-device cpu]
"""

import sys

import numpy as np

from g2o_tpu_torch.examples import split_device


def make_rig(stereo: bool, pixel_noise: float, seed: int = 0):
    from g2o_tpu_torch.core.graph import Graph
    from g2o_tpu_torch.types.sba import (
        EdgeProjectP2MC, EdgeProjectP2SC, VertexCam,
    )
    from g2o_tpu_torch.types.slam3d import VertexPointXYZ

    rng = np.random.default_rng(seed)
    fx = fy = 500.0
    cx, cy = 320.0, 240.0
    baseline = 0.075

    # two rows of cameras looking down +z (reference sba_demo scene)
    cam_states, g = [], Graph()
    vid = 0
    for iy in range(2):
        for ix in range(5):
            t = np.array([ix * 0.2, iy * 0.4, 0.0])
            q = np.array([0.0, 0.0, 0.0, 1.0])  # identity (x,y,z,w)
            state = np.concatenate([t, q, [fx, fy, cx, cy, baseline]])
            g.add_vertex(vid, VertexCam, state, fixed=(vid < 2))
            cam_states.append(state)
            vid += 1

    true_points = np.stack([
        rng.uniform(-1.5, 2.5, 500),
        rng.uniform(-1.0, 1.5, 500),
        rng.uniform(2.0, 5.0, 500),
    ], axis=1)

    def project(state, pw):
        t, q = state[:3], state[3:7]
        # w2n: R^T (p - t)
        w = q[3]
        v = q[:3]
        pn = pw - t
        pn = pn + 2 * np.cross(v, np.cross(v, pn) - w * pn)  # conj rotate
        u = (fx * pn[0] + cx * pn[2]) / pn[2]
        vv = (fy * pn[1] + cy * pn[2]) / pn[2]
        ur = (fx * (pn[0] - baseline) + cx * pn[2]) / pn[2]
        return np.array([u, vv, ur]), pn[2]

    etype = EdgeProjectP2SC if stereo else EdgeProjectP2MC
    rdim = 3 if stereo else 2
    truth = {}
    for k in range(len(true_points)):
        vis = []
        for ci, st in enumerate(cam_states):
            uvr, z = project(st, true_points[k])
            if z <= 0 or not (0 <= uvr[0] < 2 * cx and 0 <= uvr[1] < 2 * cy):
                continue
            vis.append((ci, uvr))
        if len(vis) < 2:
            continue
        init = true_points[k] + rng.normal(scale=0.5, size=3)
        g.add_vertex(vid, VertexPointXYZ, init, marginalized=True)
        truth[vid] = true_points[k]
        for ci, uvr in vis:
            obs = uvr[:rdim] + rng.normal(scale=pixel_noise, size=rdim)
            g.add_edge(etype, [vid, ci], obs, np.eye(rdim))
        vid += 1
    return g, truth


def main(argv=None):
    device, args = split_device(argv)
    pixel_noise = float(args[0]) if len(args) > 0 else 1.0
    mode = args[1] if len(args) > 1 else "stereo"

    from g2o_tpu_torch.core.lm_fused import optimize_fused
    from g2o_tpu_torch.core.solvers import SchurSolver

    g, truth = make_rig(mode == "stereo", pixel_noise)
    p = g.compile(device=device)
    res = optimize_fused(p, SchurSolver(), 12)
    errs = [np.linalg.norm(p.get_estimate(vid) - t) for vid, t in truth.items()]
    print(f"[{mode}] chi2 {res['chi2_per_iteration'][0]:.1f} -> "
          f"{res['chi2_final']:.2f} in {res['iterations']} iterations; "
          f"median point error {np.median(errs):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
