"""Wall time per λ-trial of the PyTorch port's two sphere2500 paths on the
CUDA card, for comparing two checkouts in turns.

    python3 scripts/torch_trial_wall.py [--root DIR]

Imports ``g2o_tpu_torch`` from checkout DIR (default: this one) and reads
``DIR/data/sphere2500.g2o``.  At ``chip_smoke.py``'s settings (Huber 1.0,
float32, ``PCGSolver(max_iter=50, tol=1e-1, precond="chunk2",
chunk_size=16)`` and ``SupernodalCholeskySolver()``) it warms each path up,
then runs ``optimize_fused`` for 50 iterations twice from the same start
and prints one line per run:

    [trial_wall] root=DIR path=chunk2 run=0 ms_per_lambda_trial=... ...

Run it for each checkout in the order A, B, B, A (and again), one after
the other on one card: the host's time varies between processes more
than a small change moves it.
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERATIONS, REPEATS = 50, 2


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose g2o_tpu_torch is timed")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    import g2o_tpu_torch as g2o
    from g2o_tpu_torch.io import g2o_format

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times the card")
    g = g2o_format.load(os.path.join(root, "data", "sphere2500.g2o"))
    g.set_robust_kernel("Huber", 1.0)
    p = g.compile(dtype=torch.float32, device="cuda")
    est0 = {t: v.clone() for t, v in p.estimates.items()}
    solvers = {
        "chunk2": g2o.PCGSolver(max_iter=50, tol=1e-1, precond="chunk2",
                                chunk_size=16),
        "supernodal": g2o.SupernodalCholeskySolver()}
    for name, solver in solvers.items():
        g2o.optimize_fused(p, solver, 2)                     # warm-up
        for run in range(REPEATS):
            p.set_estimates({t: v.clone() for t, v in est0.items()})
            res = g2o.optimize_fused(p, solver, ITERATIONS)
            trials = sum(res["trials_per_iteration"])
            print(f"[trial_wall] root={root} path={name} run={run} "
                  f"ms_per_lambda_trial="
                  f"{res['wall_s'] * 1e3 / max(trials, 1):.3f} "
                  f"lm_trials={trials} iterations={res['iterations']} "
                  f"chi2_final={res['chi2_final']:.4f}", flush=True)


if __name__ == "__main__":
    main()
