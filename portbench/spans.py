"""The port's own spans in a traced run of one cell.

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s>

runs the cell as ``run.py --trace 1`` does and prints one JSON line: the
run's result line (``result``), and, from the same ``torch.profiler``
events, each ``g2o.*`` span of the port (``g2o_tpu_torch.utils.tictoc
.span``) with its calls, host seconds, and inclusive device seconds,
device operations and idle seconds (``spans``); the six numbers that read
them (``derived``); the idle gaps named by the benchmark's span, the
innermost program span and the innermost host operation at their middle
(``idle_gaps``); and the host reads (``aten::_local_scalar_dense``) that
lie in no ``g2o.read.*`` span, by where they lie (``stray_reads``).

Device operations are tied to the host as ``trace.summarize`` ties them:
an operation counts in every program span open when the runtime call that
launched it started, at any depth, and an idle gap in every program span
open at its middle.  Device records named ``g2o.*`` are not work.
"""

from __future__ import annotations

import os
import sys
from collections import defaultdict
from typing import NamedTuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import trace  # noqa: E402

PREFIX = "g2o."
READ = PREFIX + "read."
SCALAR_READ = "aten::_local_scalar_dense"
TOP_OPS = 5


class SpanStats(NamedTuple):
    calls: int
    host_s: float
    device_s: float       # device time launched while the span was open
    ops: int              # device operations launched while it was open
    idle_s: float         # idle gaps whose middle lay inside it
    top_ops: list         # [[name, seconds]] of its device time, longest first


def _open_at(items, times):
    """For each of ``times``, the names of ``items`` (nested ``(start,
    end, name)`` intervals of one thread) open at it, outermost first."""
    items = sorted(items, key=lambda it: (it[0], -it[1]))
    out = [()] * len(times)
    stack, names, i = [], (), 0
    for k in sorted(range(len(times)), key=times.__getitem__):
        t = times[k]
        while i < len(items) and items[i][0] <= t:
            s, e, name = items[i]
            while stack and stack[-1][0] < s:
                stack.pop()
            stack.append((e, name))
            names = None
            i += 1
        while stack and stack[-1][0] < t:
            stack.pop()
            names = None
        if names is None:
            names = tuple(n for _, n in stack)
        out[k] = names
    return out


def reduce(events, spans):
    """``(stats, idle_gaps, stray_reads)`` of the window in ``events``
    (``trace.kineto_events`` tuples); ``spans`` are the benchmark's span
    names.  ``stats``: ``{program span name: SpanStats}``; ``idle_gaps``:
    ``[[name, seconds]]``, the longest first; ``stray_reads``: ``{where:
    count}`` of the scalar reads outside every ``g2o.read.*`` span."""
    win = [e for e in events if not e[1] and e[0] == trace.WINDOW]
    if not win:
        return None
    w0, w1, host_thread = win[0][2], win[0][3], win[0][6]
    bench_items, prog_items, host_items = [], [], []
    runtime_at, op_at, device, scalar_reads = {}, {}, [], []
    for name, on_device, s, e, corr, linked, thread in events:
        if on_device:
            if (s >= w0 and e <= w1 and "Sync" not in name
                    and name not in spans and name != trace.WINDOW
                    and not name.startswith(PREFIX)):
                device.append((s, e, name, corr, linked))
            continue
        (runtime_at if name.startswith("cu") else op_at).setdefault(corr, s)
        if thread != host_thread or s < w0 or s > w1:
            continue
        if name in spans:
            bench_items.append((s, e, name))
        elif name.startswith(PREFIX):
            prog_items.append((s, e, name))
        elif name != trace.WINDOW:
            host_items.append((s, e, name))
            if name == SCALAR_READ:
                scalar_reads.append(s)
    bench_items.sort()
    host_items.sort()

    calls, host_s = defaultdict(int), defaultdict(float)
    for s, e, name in prog_items:
        calls[name] += 1
        host_s[name] += (e - s) * 1e-9
    dev_s, ops, idle = defaultdict(float), defaultdict(int), defaultdict(float)
    by_op = defaultdict(lambda: defaultdict(float))
    launched = [(s, e, name, runtime_at.get(corr, op_at.get(linked)))
                for s, e, name, corr, linked in device]
    launched = [d for d in launched if d[3] is not None]
    for (s, e, op, _), open_ in zip(launched, _open_at(
            prog_items, [d[3] for d in launched])):
        for name in set(open_):
            dev_s[name] += (e - s) * 1e-9
            ops[name] += 1
            by_op[name][op] += (e - s) * 1e-9

    busy = trace._union((s, e) for s, e, _, _, _ in device)
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    mids = [(a + b) // 2 for a, b in gaps]
    bench_starts = [s for s, _, _ in bench_items]
    host_starts = [s for s, _, _ in host_items]
    named = defaultdict(float)
    for (a, b), mid, open_ in zip(gaps, mids, _open_at(prog_items, mids)):
        for name in set(open_):
            idle[name] += (b - a) * 1e-9
        what = "/".join(x for x in (
            trace._innermost(bench_starts, bench_items, mid),
            open_[-1] if open_ else None,
            trace._innermost(host_starts, host_items, mid)) if x) or "host"
        named[what] += (b - a) * 1e-9

    stray = defaultdict(int)
    for t, open_ in zip(scalar_reads, _open_at(prog_items, scalar_reads)):
        if not any(n.startswith(READ) for n in open_):
            where = "/".join(x for x in (
                trace._innermost(bench_starts, bench_items, t),
                open_[-1] if open_ else None) if x) or "window"
            stray[where] += 1

    def top(d, n):
        return [[k, v] for k, v in sorted(d.items(),
                                          key=lambda kv: -kv[1])[:n]]

    stats = {name: SpanStats(calls[name], host_s[name], dev_s[name],
                             ops[name], idle[name], top(by_op[name], TOP_OPS))
             for name in sorted(calls)}
    return stats, top(named, trace.TOP), dict(stray)


def derived(stats):
    """The six per-span numbers: host reads and device operations per
    λ-trial, host ms per CG iteration, idle ms in the CG stage per
    implicit solve, device ms in the explicit solve's pair and factor
    stages per explicit solve; a number whose spans are absent is None."""
    def get(name):
        return stats.get(PREFIX + name)

    def per(num, den, scale=1.0):
        return None if num is None or not den else scale * num / den

    trial, cg_iter = get("lm.trial"), get("cg.iter")
    isolve, cg = get("schur_implicit.solve"), get("schur_implicit.cg")
    esolve, pairs, factor = (get("schur.solve"), get("schur.pairs"),
                             get("schur.factor"))
    reads = sum(s.calls for k, s in stats.items() if k.startswith(READ))
    n_trial = trial.calls if trial else 0
    return {
        "host_reads_per_trial": per(reads if trial else None, n_trial),
        "launches_per_trial": per(trial.ops if trial else None, n_trial),
        "cg_iter_ms": per(cg_iter.host_s if cg_iter else None,
                          cg_iter.calls if cg_iter else 0, 1e3),
        "cg_idle_ms": per(cg.idle_s if cg else None,
                          isolve.calls if isolve else 0, 1e3),
        "explicit_pairs_ms": per(pairs.device_s if pairs else None,
                                 esolve.calls if esolve else 0, 1e3),
        "explicit_factor_ms": per(factor.device_s if factor else None,
                                  esolve.calls if esolve else 0, 1e3),
    }


def expected_reads(jobs, implicit):
    """The host reads ``optimize_fused`` makes in ``jobs`` (its result
    dicts): λ₀ and the first chi2 a job, chi2 an iteration, chi2 and the
    gain ratio a trial, and in the implicit solver a stop test a CG
    iteration, the one that ends each solve, and the Cholesky inverse of
    the preconditioner's camera blocks a solve."""
    n = 0
    for r in jobs:
        trials = sum(r["trials_per_iteration"])
        n += 2 + r["iterations"] + 2 * trials
        if implicit:
            n += sum(r["cg_per_iteration"]) + 2 * trials
    return n


def main(argv=None):
    import argparse
    import json

    import torch

    from portbench import bench

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    kept = []
    kineto_events = trace.kineto_events

    def keep(prof):
        kept.append(kineto_events(prof))
        return kept[-1]

    import g2o_tpu_torch

    jobs = []
    optimize = g2o_tpu_torch.optimize_fused

    def recording(*a, **kw):
        res = optimize(*a, **kw)
        if torch.autograd._profiler_enabled():
            jobs.append(res)
        return res

    # the run's own events and the window's result dicts, kept as they pass
    trace.kineto_events = keep
    g2o_tpu_torch.optimize_fused = recording
    try:
        out = bench.run_cell(ROOT, args.workload, args.seed, args.seconds,
                             True, args.device)
    finally:
        trace.kineto_events = kineto_events
        g2o_tpu_torch.optimize_fused = optimize
    stats, gaps, stray = reduce(kept[0], bench.SPANS)
    _, _, config, _, _, _ = bench.find_cell(ROOT, args.workload)
    line = {"result": out,
            "jobs": len(jobs),
            "reads_expected": expected_reads(
                jobs, config.get("solve_layer") == "implicit"),
            "spans": {k: v._asdict() for k, v in stats.items()},
            "derived": derived(stats),
            "idle_gaps": gaps, "stray_reads": stray}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
