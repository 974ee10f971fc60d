"""Designs of the dims-major gather (K5/K10) on the CUDA card: variants of
``g2o_tpu_torch/csrc/gather_segment.cu``'s ``gather_t_kernel``, each with
one choice changed, built side by side and timed at the three dims-major
implicit Schur paths' shapes.

    python3 scripts/gather_t_probe.py [--parent DIR] [--rounds 4]

The shapes are ``(S, 9) -> (9, N)`` with the paths' own camera ids, as
``chip_smoke.py`` loads them: ladybug (49, 35000), stress (120, 198088)
and Venice (800, 900000), f32.  Variants (each computes the whole gather,
and each must equal the plain version bit for bit):

* ``ship``: the source as it is;
* ``l1``: the table read through ``__ldg`` (L1) instead of staged in
  shared memory, so no barrier before the first store;
* ``fixed64`` … ``fixed1024``: blocks of that many threads at every
  shape, where the source halves ``GATHER_T_THREADS`` (1024) down to
  ``GATHER_T_MIN_THREADS`` (64) while the items fill fewer than half as
  many blocks as there are SMs; ``min128``: halved down to 128 only;
* ``halve_below_one``: halved while the items fill fewer blocks than
  there are SMs (instead of half as many);
* ``stage_serial``: the table staged one load per thread at a time
  instead of :data:`GATHER_T_STAGE_LOADS` in flight;
* ``unroll3``: the loop over the rows unrolled 3 times instead of 9;
* ``persistent``: one block per SM, each thread walking several groups
  with its next ids in flight;
* ``no_prefetch``: each thread's next ids loaded after its stores;
* ``scalar``: one thread per edge at every shape (the ragged branch);
* ``parent``: with ``--parent DIR``, that checkout's ``gather_segment.cu``
  as it is.

For each: ``device_us`` and ``ops`` (``torch.profiler``, per call), the
median of ``--rounds`` in turns.  The first line names the card and its
power limit.
"""

import argparse
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "scripts"))

THREADS = "constexpr int GATHER_T_THREADS = 1024;"
MIN_THREADS = "constexpr int GATHER_T_MIN_THREADS = 64;"
LOAD_NEXT = ("    load(it + stride);                        "
             "// the next ids, before the stores\n")
SCALAR_END = ("? value(off[0] + d) : T(0);\n    }\n")


def _fixed(threads):
    """Blocks of ``threads`` at every shape (no halving)."""
    return [(THREADS, THREADS.replace("1024", str(threads))),
            (MIN_THREADS, MIN_THREADS.replace("64", str(threads)))]


VARIANTS = {
    "ship": [],
    "l1": [("const bool stage = tbytes <= GATHER_T_STAGE_MAX;",
            "const bool stage = false;")],
    **{f"fixed{t}": _fixed(t) for t in (64, 128, 256, 512, 1024)},
    "min128": [(MIN_THREADS, MIN_THREADS.replace("64", "128"))],
    "persistent": [("if (blocks > per_sm * sms) blocks = per_sm * sms;",
                    "if (blocks > sms) blocks = sms;")],
    "no_prefetch": [(LOAD_NEXT, ""),
                    (SCALAR_END, SCALAR_END + "    load(it + stride);\n")],
    "scalar": [("const int vec = N % V == 0 &&",
                "const int vec = 0 && N % V == 0 &&")],
    "stage_serial": [("constexpr int GATHER_T_STAGE_LOADS = 8;",
                      "constexpr int GATHER_T_STAGE_LOADS = 1;")],
    "unroll3": [("#pragma unroll 9", "#pragma unroll 3")],
    "halve_below_one": [("2 * items < bt * sms", "items < bt * sms")],
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="checkout whose gather_segment.cu is "
                    "timed beside the variants")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    sys.path.insert(0, HERE)

    import torch

    import chip_smoke
    import g2o_tpu_torch as g2o
    from g2o_tpu_torch.ops import chol_kernels as ck
    from g2o_tpu_torch.ops import onehot as oh
    from rowsum_probe import build

    card = chip_smoke.device_phase(torch)
    os.makedirs(ck.BUILD_DIR, exist_ok=True)
    fns = build(ck.BUILD_DIR, VARIANTS, ck.SOURCES["gather_segment"], "gt",
                "gather_t_kernel", "g2o_gather_f32")
    if args.parent:
        src = os.path.join(os.path.abspath(args.parent), "g2o_tpu_torch",
                           "csrc", "gather_segment.cu")
        fns.update(build(ck.BUILD_DIR, {"parent": []}, src, "gt_parent",
                         "gather_kernel", "g2o_gather_f32"))
    path_ids = chip_smoke._path_ids(chip_smoke.load_implicit(torch, g2o))
    rng = np.random.default_rng(9)
    for kind in ("ladybug_dm", "stress_dm", "venice"):
        ids, S = path_ids[kind]
        N, D = ids.shape[0], 9
        table = torch.as_tensor(rng.standard_normal((S, D)),
                                dtype=torch.float32, device="cuda")
        want = oh.onehot_gather_t_plain(ids, table)
        outs = {}

        def call_of(name, fn):
            out = outs.setdefault(name, table.new_full((D, N), float("nan")))

            def call():
                err = fn(table.data_ptr(), ids.data_ptr(), out.data_ptr(), N,
                         S, D, 1, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            return call

        calls = {name: call_of(name, fn) for name, fn in fns.items()}
        for name, call in calls.items():
            call()
            torch.cuda.synchronize()
            if not torch.equal(outs[name], want):
                raise RuntimeError(f"{name} disagrees with the plain version "
                                   f"at {kind}")
        res = {k: [] for k in calls}
        ops = {}
        for r in range(args.rounds):
            for name in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
                us, ops[name] = chip_smoke.device_profile(torch, calls[name])
                res[name].append(us)
        b_ms, _ = chip_smoke.bound("onehot_gather", (N, D, S))
        print(f"[gather_t_probe] card={card.replace(' ', '_')} path={kind} "
              f"N={N} D={D} S={S} bound_us={b_ms * 1e3:.2f} " + " ".join(
                  f"{k}:device_us={float(np.median(v)):.2f}/ops={ops[k]}"
                  for k, v in res.items()), flush=True)


if __name__ == "__main__":
    main()
