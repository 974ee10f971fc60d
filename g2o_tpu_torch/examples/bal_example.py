"""BAL bundle adjustment — port of ``examples/bal_example.py``, the
analogue of the reference ``examples/bal/bal_example.cpp``: read a BAL
dataset (9-dof Rodrigues cameras with radial distortion — where the
reference uses ceres autodiff ``bal_example.cpp:65-285``, here
``torch.func`` differentiates the same model exactly), optimize with LM,
write the point cloud.

Run: python -m g2o_tpu_torch.examples.bal_example [problem.txt]
     [iterations] [-device cpu]
A synthetic Ladybug-like problem is generated when no file is given.
"""

import io
import sys

from g2o_tpu_torch.examples import split_device


def main(argv=None):
    device, args = split_device(argv)
    path = args[0] if len(args) > 0 else None
    iters = int(args[1]) if len(args) > 1 else 20

    from g2o_tpu_torch.core.lm_fused import optimize_fused
    from g2o_tpu_torch.core.solvers import SchurSolver
    from g2o_tpu_torch.io.bal import load_bal_problem, make_synthetic_bal

    if path is None:
        print("no input file: generating a synthetic Ladybug-like problem")
        src = io.StringIO(make_synthetic_bal(n_cameras=49, n_points=2000,
                                             n_obs_per_point=6))
    else:
        src = path
    p = load_bal_problem(src, huber=1.0, device=device)
    n_cams = p.counts["VERTEX_CAMERA_BAL"]
    n_pts = p.counts["VERTEX_TRACKXYZ"]
    print(f"loaded: {n_cams} cameras, {n_pts} points")

    res = optimize_fused(p, SchurSolver(), iters)
    chis = res["chi2_per_iteration"]
    print(f"chi2 {chis[0]:.1f} -> {res['chi2_final']:.2f} "
          f"in {res['iterations']} LM iterations ({res['wall_s']:.2f}s)")

    # write the optimized point cloud like the reference's PLY dump
    # (``bal_example.cpp`` WriteToPLYFile)
    out = (path or "synthetic_bal") + ".ply"
    pts = p.estimates["VERTEX_TRACKXYZ"].cpu().numpy()
    with open(out, "w") as fh:
        fh.write("ply\nformat ascii 1.0\n"
                 f"element vertex {len(pts)}\n"
                 "property float x\nproperty float y\nproperty float z\n"
                 "end_header\n")
        for q in pts:
            fh.write(f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f}\n")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
