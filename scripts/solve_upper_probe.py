"""Where K3's device time goes, on the CUDA card: variants of
``g2o_tpu_torch/csrc/batched_chol.cu``, each with one phase of the
single-column backward substitution (``solve_upper_chain``) cut out, built
side by side and timed at the supernodal sweep's shapes, (S, 144, 1) f32.

    python3 scripts/solve_upper_probe.py [--rounds 4] [--s 1 55]

Variants (a cut variant computes a wrong X and is timed only):

* ``ship``: the source as it is;
* ``no_chain``: without the shuffle chain of each 32-row diagonal tile;
* ``no_update``: without the updates of the rows above a finished tile
  (their loads kept);
* ``no_sweep``: without the sweep (the rhs and the diagonal tiles'
  coefficients only);
* ``no_coef``: without the diagonal tiles' coefficients formed up front
  (the chains read stale shared memory);
* ``launch_only``: neither the coefficients nor the sweep (the launch and
  the rhs).

For each: ``device_us`` (``torch.profiler``, per call), the median of
``--rounds`` in turns, beside ``torch.linalg.solve_triangular``.  The
first line names the card and its power limit.
"""

import argparse
import ctypes
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "scripts"))

SWEEP = "  for (int t = nt - 1; t >= 0; --t) {\n    const int i0"
NO_SWEEP = "  for (int t = -1; t >= 0; --t) {\n    const int i0"
NO_COEF = ("  for (int t = warp; t < nt; t += UP_THREADS / 32) {",
           "  for (int t = nt; t < nt; t += UP_THREADS / 32) {")
VARIANTS = {
    "ship": [],
    "no_chain": [("        if (k >= rows) continue;                  // the same "
                  "for the warp", "        continue;")],
    "no_update": [("for (int i = lo; i < hi;", "for (int i = hi; i < hi;")],
    "no_sweep": [(SWEEP, NO_SWEEP)],
    "no_coef": [NO_COEF],
    "launch_only": [(SWEEP, NO_SWEEP), NO_COEF],
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--s", type=int, nargs="+", default=[1, 55])
    args = ap.parse_args()
    sys.path.insert(0, HERE)

    import torch

    import chip_smoke
    from g2o_tpu_torch.ops import chol_kernels as ck
    from rowsum_probe import build

    card = chip_smoke.device_phase(torch)
    os.makedirs(ck.BUILD_DIR, exist_ok=True)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fns = build(ck.BUILD_DIR, VARIANTS, ck.SOURCES["batched_chol"], "k3",
                "solve_upper_chain", "g2o_solve_upper_batched_f32",
                [vp, vp, vp, ci, ci, ci, vp])
    rng = np.random.default_rng(8)
    n = 144
    for S in args.s:
        A = rng.standard_normal((S, n, n))
        L = torch.linalg.cholesky(torch.as_tensor(
            A @ A.transpose(0, 2, 1) + n * np.eye(n), dtype=torch.float32,
            device="cuda")).contiguous()
        B = torch.as_tensor(rng.standard_normal((S, n, 1)),
                            dtype=torch.float32, device="cuda")
        X = torch.empty_like(B)

        def call_of(fn):
            def call():
                err = fn(L.data_ptr(), B.data_ptr(), X.data_ptr(), S, n, 1,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"CUDA error {err}")
            return call

        calls = {k: call_of(fn) for k, fn in fns.items()}
        calls["solve_triangular"] = lambda: torch.linalg.solve_triangular(
            L.mT, B, upper=True)
        calls["ship"]()
        want = ck.solve_upper_batched_plain(L, B)
        torch.cuda.synchronize()
        if float((X - want).abs().max()) > 2e-5 * float(want.abs().max()):
            raise RuntimeError("ship disagrees with the plain version")
        res = {k: [] for k in calls}
        for r in range(args.rounds):
            for k in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
                res[k].append(chip_smoke.device_profile(torch, calls[k])[0])
        print(f"[k3_probe] card={card.replace(' ', '_')} shape={S}x{n}x1 "
              + " ".join(f"{k}:device_us={float(np.median(v)):.2f}"
                         for k, v in res.items()), flush=True)


if __name__ == "__main__":
    main()
