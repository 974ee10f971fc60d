"""Per-call cost of the gather and segment-sum wrappers (K5–K8) at the
implicit Schur paths' shapes, on the CUDA card, this checkout against a
parent checkout's kernels and wrappers in one process.

    python3 scripts/onehot_ab.py [--parent DIR] [--sweep] [--json PATH]

Loads the four implicit Schur problems as ``chip_smoke.py`` does (ladybug,
stress and Venice dims-major, ladybug runtime-bucketed) and takes the camera
ids each path hands the kernels.  For each wrapper a path launches, at that
path's shape, it measures in turns (parent, this, library, library, this,
parent):

* ``window_us``: CUDA events around ``--reps`` calls back to back, per call
  (what ``chip_smoke.py``'s ``_time_ms`` reads);
* ``host_us``: the host clock over the same loop, before the synchronize,
  per call (the time the caller's thread spends in the wrapper);
* ``device_us`` and ``device_ops``: ``torch.profiler``'s device time and
  device operations (kernels, memsets, copies) per call.

With ``--parent DIR`` the parent's ``csrc/gather_segment.cu`` is built with
the same nvcc flags beside this checkout's library and its
``ops/onehot.py`` is loaded under another name, bound to that build.
Without it only this checkout and the library call are timed.  ``--sweep``
also times this checkout's row-major segment sum at 35000 rows of 9 values
over the number of segments up to ``ops/onehot.py``'s ``ROWSUM_MAX_CELLS``,
its one-launch branch against its memset branch in alternating pairs,
each called through the library's entry point with the same host work.

Every line names the card and its power limit; ``--json PATH`` also
writes the whole result there.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _measure(torch, fn, reps, prof_calls=10):
    """``{window_us, host_us, device_us, device_ops}`` of ``fn``, per call."""
    from chip_smoke import device_profile

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    end.record()
    torch.cuda.synchronize()
    dev_us, ops = device_profile(torch, fn, prof_calls)
    return dict(window_us=start.elapsed_time(end) * 1e3 / reps,
                host_us=(t1 - t0) * 1e6 / reps, device_us=dev_us,
                device_ops=ops)


def _parent_onehot(parent):
    """The parent's ``ops/onehot.py``, bound to its own kernel library."""
    from g2o_tpu_torch.ops import chol_kernels as ck

    src = os.path.join(parent, "g2o_tpu_torch", "csrc", "gather_segment.cu")
    os.makedirs(ck.BUILD_DIR, exist_ok=True)
    so = os.path.join(ck.BUILD_DIR, "libgather_segment_parent.so")
    subprocess.run([ck._nvcc(), *ck.NVCC_FLAGS, "-o", so, src], check=True,
                   cwd=os.path.dirname(src))
    spec = importlib.util.spec_from_file_location(
        "onehot_parent",
        os.path.join(parent, "g2o_tpu_torch", "ops", "onehot.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build = lambda *names: [so]          # its _load() binds this build
    mod._load()
    return mod


def _cases(path_ids):
    """``(path, wrapper, D)`` for each wrapper each path launches."""
    out = []
    for path, (ids, S) in path_ids.items():
        if path.endswith("_runtime"):
            out += [(path, "onehot_gather", 9), (path, "onehot_scatter_add", 9)]
        else:
            out += [(path, "onehot_gather_t", 9),
                    (path, "onehot_scatter_add_t", 9),
                    (path, "onehot_scatter_add_t", 81)]
    return out


def _calls(torch, sides, wrapper, ids, S, D, rng):
    """``{side: call}`` of ``wrapper`` on one set of fresh inputs of the
    path's shape, and ``"library"``: the one PyTorch call for it."""
    N = ids.shape[0]
    table = torch.as_tensor(rng.standard_normal((S, D)), dtype=torch.float32,
                            device="cuda")
    rows = torch.as_tensor(rng.standard_normal((N, D)), dtype=torch.float32,
                           device="cuda")
    rows_t = rows.T.contiguous()
    tz = torch.cat([table, table.new_zeros((1, D))])
    tzt = tz.T.contiguous()
    Z, Zt = tz.new_zeros((S + 1, D)), tz.new_zeros((D, S + 1))
    args, lib = {
        "onehot_gather": ((ids, table),
                          lambda: torch.index_select(tz, 0, ids)),
        "onehot_gather_t": ((ids, table),
                            lambda: torch.index_select(tzt, 1, ids)),
        "onehot_scatter_add": ((ids, rows, S),
                               lambda: torch.index_add(Z, 0, ids, rows)),
        "onehot_scatter_add_t": ((ids, rows_t, S),
                                 lambda: torch.index_add(Zt, 1, ids, rows_t)),
    }[wrapper]
    out = {side: (lambda fn=getattr(mod, wrapper): fn(*args))
           for side, mod in sides.items()}
    out["library"] = lib
    out["args"] = args
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="checkout whose kernels are timed beside "
                    "this one's")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--json", help="file for the whole result")
    args = ap.parse_args()
    sys.path.insert(0, HERE)

    import torch

    import chip_smoke
    import g2o_tpu_torch as g2o
    from g2o_tpu_torch.ops import chol_kernels as ck
    from g2o_tpu_torch.ops import onehot as oh

    card = chip_smoke.device_phase(torch)
    ck.build()
    sides = {"this": oh}
    if args.parent:
        sides = {"parent": _parent_onehot(os.path.abspath(args.parent)),
                 "this": oh}
    implicit = chip_smoke.load_implicit(torch, g2o)
    path_ids = chip_smoke._path_ids(implicit)
    del implicit
    rng = np.random.default_rng(4)
    order = [*sides, "library", "library", *list(sides)[::-1]]
    result = {"card": card, "reps": args.reps, "cases": []}
    for path, wrapper, D in _cases(path_ids):
        ids, S = path_ids[path]
        calls = _calls(torch, sides, wrapper, ids, S, D, rng)
        # the sides agree with the plain version: the gather exactly, the
        # sums to float32 rounding (read after every case is timed)
        ref = getattr(oh, wrapper + "_plain")(*calls["args"])
        tol = 0 if "gather" in wrapper else 2e-5 * float(ref.abs().max())
        agree = {side: float((calls[side]() - ref).abs().max()) <= tol
                 for side in sides}
        runs = {k: [] for k in order}
        for k in order:
            runs[k].append(_measure(torch, calls[k], args.reps))
        med = {k: {m: float(np.median([r[m] for r in v])) for m in v[0]}
               for k, v in runs.items()}
        case = dict(path=path, wrapper=wrapper, shape=[ids.shape[0], D, S],
                    agree=agree, **med)
        result["cases"].append(case)
        print(f"[onehot_ab] card={card.replace(' ', '_')} path={path} "
              f"wrapper={wrapper} N={ids.shape[0]} D={D} S={S} "
              f"agree={all(agree.values())} " + " ".join(
                  f"{k}:{m}={v[m]:.2f}" for k, v in med.items()
                  for m in ("window_us", "host_us", "device_us",
                            "device_ops")), flush=True)
    if args.sweep:
        result["sweep"] = sweep(torch, oh, card, args.reps)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(result, fh, indent=1)
    wrong = [(c["path"], c["wrapper"], side) for c in result["cases"]
             for side, ok in c["agree"].items() if not ok]
    if wrong:
        raise RuntimeError(f"disagrees with the plain version: {wrong}")


def _entry_call(torch, oh, ids, rows, S, one_launch):
    """A call of the row-major segment sum's entry point with the host work
    of the wrapper's launch (output, stream) and none of its checks: the
    one-launch branch, or the memset branch (forced by passing a larger
    S, with the ids kept below S)."""
    oh._load()
    fn = oh._FNS["scatter_add", rows.dtype]
    N, D = rows.shape
    S_arg = S if one_launch else oh.ROWSUM_MAX_CELLS // D + 1
    index = rows.device.index

    def call():
        out = rows.new_empty((S_arg, D))
        err = fn(rows.data_ptr(), ids.data_ptr(), out.data_ptr(), N, S_arg, D,
                 0, oh._raw_stream(index))
        if err:
            raise RuntimeError(f"segment sum failed: CUDA error {err}")
        return out[:S]
    return call


def sweep(torch, oh, card, reps, pairs=4):
    """The row-major segment sum at N = 35000 rows of D = 9 over S up to
    ``ROWSUM_MAX_CELLS``: its one-launch and memset branches in
    ``pairs`` alternating pairs (one launch first, then the memset, then
    the reverse), the medians of :func:`_measure`'s measures per call."""
    rng = np.random.default_rng(5)
    out = []
    N, D = 35000, 9
    rows = torch.as_tensor(rng.standard_normal((N, D)), dtype=torch.float32,
                           device="cuda")
    for S in (1, 10, 49, 85):
        assert S * D <= oh.ROWSUM_MAX_CELLS
        ids = torch.as_tensor(rng.integers(0, S + 1, N).astype(np.int32),
                              device="cuda")
        calls = {b: _entry_call(torch, oh, ids, rows, S, b == "one_launch")
                 for b in ("one_launch", "memset")}
        want = oh.onehot_scatter_add_plain(ids, rows, S)
        for b, fn in calls.items():
            if float((fn() - want).abs().max()) > 2e-5 * float(
                    want.abs().max()):
                raise RuntimeError(f"sweep {b} S={S} disagrees")
        line = dict(N=N, D=D, S=S, pairs=pairs)
        runs = {b: [] for b in calls}
        for r in range(pairs):
            for b in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
                runs[b].append(_measure(torch, calls[b], reps))
        for b, v in runs.items():
            line[b] = {k: float(np.median([m[k] for m in v])) for k in v[0]}
        out.append(line)
        print(f"[onehot_sweep] card={card.replace(' ', '_')} N={N} D={D} "
              f"S={S} pairs={pairs} " + " ".join(
                  f"{b}:{k}={line[b][k]:.2f}" for b in calls
                  for k in ("device_us", "window_us", "host_us",
                            "device_ops")), flush=True)
    return out


if __name__ == "__main__":
    main()
