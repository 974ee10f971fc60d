"""Self-contained 2D SLAM tutorial — port of
``examples/tutorial_slam2d.py``, the analogue of the reference
``examples/tutorial_slam2d/`` (which carries its own simulator + types):
simulate a robot on a grid observing landmarks, integrate noisy odometry as
the initial guess, optimize, and report trajectory ATE against ground truth.

Run: python -m g2o_tpu_torch.examples.tutorial_slam2d [-device cpu]
"""

import sys

import numpy as np

from g2o_tpu_torch.examples import split_device


def se2_mul(a, b):
    c, s = np.cos(a[2]), np.sin(a[2])
    th = (a[2] + b[2] + np.pi) % (2 * np.pi) - np.pi
    return np.array([a[0] + c * b[0] - s * b[1],
                     a[1] + s * b[0] + c * b[1], th])


def se2_inv(a):
    c, s = np.cos(a[2]), np.sin(a[2])
    return np.array([-(c * a[0] + s * a[1]), s * a[0] - c * a[1], -a[2]])


def main(argv=None):
    device, _ = split_device(argv)
    import g2o_tpu_torch
    from g2o_tpu_torch.core.graph import Graph
    from g2o_tpu_torch.core.solvers import PCGSolver
    from g2o_tpu_torch.types.slam2d import EdgeSE2, EdgeSE2PointXY, VertexSE2, \
        VertexPointXY
    from g2o_tpu_torch.utils.metrics import ate

    rng = np.random.default_rng(7)
    trans_sigma, rot_sigma, lm_sigma = 0.05, 0.02, 0.05

    # --- simulate: square laps on a grid (the tutorial's scenario) ---
    n_steps, side = 160, 10
    gt = [np.zeros(3)]
    for i in range(n_steps):
        step = np.array([1.0, 0.0, 0.0])
        if (i + 1) % side == 0:
            step[2] = np.pi / 2
        gt.append(se2_mul(gt[-1], step))
    landmarks = rng.uniform(-2, 12, size=(40, 2))

    # --- noisy odometry + integrated initial guess ---
    odo, guess = [], [gt[0]]
    for i in range(1, len(gt)):
        rel = se2_mul(se2_inv(gt[i - 1]), gt[i])
        noisy = rel + rng.normal(0, [trans_sigma, trans_sigma, rot_sigma])
        odo.append(noisy)
        guess.append(se2_mul(guess[-1], noisy))

    g = Graph()
    info_odo = np.diag([1 / trans_sigma ** 2] * 2 + [1 / rot_sigma ** 2])
    info_lm = np.eye(2) / lm_sigma ** 2
    for i, p in enumerate(guess):
        g.add_vertex(i, VertexSE2, p, fixed=(i == 0))
    for i in range(1, len(gt)):
        g.add_edge(EdgeSE2, [i - 1, i], odo[i - 1], info_odo)
    lm_vid0, seen = len(gt), {}
    for i, p in enumerate(gt):
        c, s = np.cos(p[2]), np.sin(p[2])
        for k, lm in enumerate(landmarks):
            rel = lm - p[:2]
            if np.linalg.norm(rel) > 4.0:
                continue
            local = np.array([c * rel[0] + s * rel[1],
                              -s * rel[0] + c * rel[1]])
            obs = local + rng.normal(0, lm_sigma, 2)
            vid = lm_vid0 + k
            if vid not in seen:
                gp = guess[i]
                cg, sg = np.cos(gp[2]), np.sin(gp[2])
                world = gp[:2] + np.array([cg * obs[0] - sg * obs[1],
                                           sg * obs[0] + cg * obs[1]])
                g.add_vertex(vid, VertexPointXY, world)
                seen[vid] = True
            g.add_edge(EdgeSE2PointXY, [i, vid], obs, info_lm)

    p = g.compile(device=device)
    gt_arr = np.stack(gt)
    before = ate(np.stack(guess), gt_arr)
    opt = g2o_tpu_torch.SparseOptimizer(
        p, algorithm=g2o_tpu_torch.LevenbergMarquardt(),
        solver=PCGSolver(max_iter=100), verbose=True)
    opt.optimize(10)
    est = p.estimates_by_vid()
    after = ate(np.stack([np.asarray(est[i]) for i in range(len(gt))]), gt_arr)
    print(f"trajectory ATE: {before:.4f} m (odometry) -> {after:.4f} m "
          f"(optimized), {len(gt)} poses, {len(seen)} landmarks")
    assert after < before
    return 0


if __name__ == "__main__":
    sys.exit(main())
