"""Per-call cost of the gather and segment-sum wrappers (K5–K8) at the
implicit Schur paths' shapes, on the CUDA card, this checkout against a
parent checkout's kernels and wrappers in one process.

    python3 scripts/onehot_ab.py [--parent DIR] [--sweep] [--k3] [--json PATH]

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

``--k3`` also times K3 (``ops/chol_kernels.py::solve_upper_batched``) at
the supernodal sweep's shapes, (1|2|3|12|55, 144, 1) f32, and at the wider
ones of :data:`K3_SHAPES`, the same way
beside ``torch.linalg.solve_triangular`` (and the parent's K3 with
``--parent``), after holding each side against the plain version.

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


def _parent_module(parent, module="onehot", lib="gather_segment"):
    """The parent's ``ops/<module>.py``, bound to its own build of
    ``csrc/<lib>.cu``."""
    from g2o_tpu_torch.ops import chol_kernels as ck

    src = os.path.join(parent, "g2o_tpu_torch", "csrc", f"{lib}.cu")
    os.makedirs(ck.BUILD_DIR, exist_ok=True)
    so = os.path.join(ck.BUILD_DIR, f"lib{lib}_parent.so")
    subprocess.run([ck._nvcc(), *ck.NVCC_FLAGS, "-o", so, src], check=True,
                   cwd=os.path.dirname(src))
    spec = importlib.util.spec_from_file_location(
        f"{module}_parent",
        os.path.join(parent, "g2o_tpu_torch", "ops", f"{module}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build = lambda *names: [so]          # its _load() binds this build
    mod._load()
    return mod


# K3's shapes: the supernodal sweep's (S, 144, 1), then the wider ones that
# chip_smoke.py times it at (B = I where n == m) and a Pallas test shape
K3_SHAPES = [(1, 144, 1), (2, 144, 1), (3, 144, 1), (12, 144, 1),
             (55, 144, 1), (1, 960, 960), (55, 144, 144), (55, 144, 192),
             (5, 126, 96)]


def k3_ab(torch, card, parent, reps):
    """K3 at :data:`K3_SHAPES`: ``{window_us, host_us,
    device_us, device_ops}`` per call of this checkout's, the parent's
    (with ``parent``) and ``solve_triangular``, in turns (parent, this,
    library, library, this, parent), each side first held against the
    plain version within 2e-5 of the largest entry."""
    from g2o_tpu_torch.ops import chol_kernels as ck

    sides = {"this": ck}
    if parent:
        sides = {"parent": _parent_module(parent, "chol_kernels",
                                          "batched_chol"), "this": ck}
    order = [*sides, "library", "library", *list(sides)[::-1]]
    rng = np.random.default_rng(7)
    out = []
    for S, n, m in K3_SHAPES:
        A = rng.standard_normal((S, n, n))
        L = torch.linalg.cholesky(torch.as_tensor(
            A @ A.transpose(0, 2, 1) + n * np.eye(n), dtype=torch.float32,
            device="cuda")).contiguous()
        B = (torch.eye(n, device="cuda").expand(S, n, n).contiguous()
             if n == m else torch.as_tensor(rng.standard_normal((S, n, m)),
                                            dtype=torch.float32,
                                            device="cuda"))
        calls = {side: (lambda m=mod: m.solve_upper_batched(L, B))
                 for side, mod in sides.items()}
        calls["library"] = lambda: torch.linalg.solve_triangular(
            L.mT, B, upper=True)
        want = ck.solve_upper_batched_plain(L, B)
        for side in sides:
            err = float((calls[side]() - want).abs().max())
            if err > 2e-5 * float(want.abs().max()):
                raise RuntimeError(f"K3 {side} disagrees at {(S, n, m)}: "
                                   f"{err}")
        runs = {k: [] for k in order}
        for k in order:
            runs[k].append(_measure(torch, calls[k], reps))
        med = {k: {m: float(np.median([r[m] for r in v])) for m in v[0]}
               for k, v in runs.items()}
        out.append(dict(shape=[S, n, m], **med))
        print(f"[k3_ab] card={card.replace(' ', '_')} shape={S}x{n}x{m} "
              + " ".join(f"{k}:{m}={v[m]:.2f}" for k, v in med.items()
                         for m in ("window_us", "host_us", "device_us",
                                   "device_ops")), flush=True)
    return out


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
    ap.add_argument("--k3", action="store_true", help="also time K3 at the "
                    "supernodal sweep's shapes")
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
        sides = {"parent": _parent_module(os.path.abspath(args.parent)),
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
    if args.k3:
        result["k3"] = k3_ab(torch, card, args.parent and os.path.abspath(
            args.parent), args.reps)
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
