"""Minimal load-and-optimize — port of ``examples/simple_optimize.py``,
the analogue of the reference ``examples/simple_optimize.cpp``.

Run: python -m g2o_tpu_torch.examples.simple_optimize graph.g2o
     [iterations] [-device cpu]
"""

import sys

from g2o_tpu_torch.examples import split_device


def main(argv=None):
    device, args = split_device(argv)
    if len(args) < 1:
        print("usage: simple_optimize.py graph.g2o [iterations]")
        return 1
    iters = int(args[1]) if len(args) > 1 else 10

    import g2o_tpu_torch
    from g2o_tpu_torch.core.solvers import PCGSolver
    from g2o_tpu_torch.io import g2o_format

    g = g2o_format.load(args[0])
    if not any(r.fixed for r in g.vertices().values()):
        g.set_fixed(min(g.vertices()), True)
    p = g.compile(device=device)
    opt = g2o_tpu_torch.SparseOptimizer(
        p, algorithm=g2o_tpu_torch.LevenbergMarquardt(), solver=PCGSolver(),
        verbose=True)
    opt.optimize(iters)
    out = args[0] + ".optimized"
    g2o_format.save(g, out, estimates_by_vid=p.estimates_by_vid())
    print(f"saved {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
