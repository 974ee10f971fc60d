"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  The build and kernel caches live in
fixed directories under ``portbench/.cache``.  Exits non-zero, printing no
result, without the CUDA devices the cell needs, or when a module of JAX
or of the JAX package is loaded once the window has closed.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "portbench", ".cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import bench

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    try:
        out = bench.run_cell(ROOT, args.workload, args.seed, args.seconds,
                             bool(args.trace), "cuda", t_start=T_START)
    except bench.CellError as exc:
        print(f"cannot run: {exc}", file=sys.stderr)
        return 2
    bad = bench.forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    checks = out["checks"]
    for name, c in checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
