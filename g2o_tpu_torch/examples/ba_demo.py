"""Synthetic bundle adjustment — port of ``examples/ba_demo.py``, the
analogue of the reference ``examples/ba/ba_demo.cpp``: build a
camera/point scene with noisy observations, optimize with the
Schur-complement path AND the square-root CGLS path (the fork's
comparison), print before/after errors.

Run: python -m g2o_tpu_torch.examples.ba_demo [pixel_noise] [-device cpu]
"""

import numpy as np

from g2o_tpu_torch.examples import split_device


def main(argv=None):
    device, args = split_device(argv)
    pixel_noise = float(args[0]) if len(args) > 0 else 1.0

    from g2o_tpu_torch.core.lm_fused import optimize_fused
    from g2o_tpu_torch.core.solvers import SchurSolver
    from g2o_tpu_torch.core.solvers.cgls import CGLSSolver
    from g2o_tpu_torch.sim.generators import create_ba_scene

    for tag, solver in (("schur", SchurSolver()),
                        ("cgls (square-root)", CGLSSolver(max_iter=100,
                                                          eta=1e-6))):
        g, truth = create_ba_scene(n_cameras=15, n_points=400,
                                   pixel_noise=pixel_noise,
                                   point_noise=0.4, seed=0)
        p = g.compile(device=device)
        res = optimize_fused(p, solver, 15)
        errs = [np.linalg.norm(p.get_estimate(vid) - t)
                for vid, t in truth.items()]
        print(f"[{tag}] chi2 {res['chi2_per_iteration'][0]:.1f} -> "
              f"{res['chi2_final']:.2f} in {res['iterations']} iterations "
              f"({res['wall_s']:.2f}s); median point error "
              f"{np.median(errs):.4f}")


if __name__ == "__main__":
    main()
