"""One run of one cell: set-up, the measured window, the judgement, the
result line.

A cell names a configuration (``configs/<name>.json``: the published sizes,
the scene's rules, the problem layout and the solver of the deployment,
the reference's solver and the limits of the judgement) and a traffic mix
(``traffic/<name>.json``: the job stream's parameters).  Every metric is a
reader in ``metrics/<name>.py``.  All three are found by the names in
``BENCHMARK.json``, so a new cell, configuration or metric is new files.

A job draws a start on the device, seats it with ``Problem.set_estimates``
and runs ``optimize_fused`` for the traffic's iterations, to a
synchronize.  The window runs jobs back to back, one client in a closed
loop, until ``seconds`` have passed and the last cycle through the pool of
starts has ended.
Spans (``record_function`` ranges, only while tracing) wrap the draw, each
``linearize_fn`` call and each solve, on the instances the run built.
Once the window has closed, the reference judges the jobs recorded in it:
``check_jobs`` drawn from the seed among the first ``check_among_first``,
and ``check_in_last_cycle`` at places of the cycle drawn from the seed,
recorded in every cycle and kept from the last.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import scene as scene_mod
from portbench import trace as trace_mod
from portbench import work
from portbench.reference.check import JobRecord, judge

SPANS = ("job.draw", "lm.linearize", "lm.solve")
DTYPES = {"float32": torch.float32, "float64": torch.float64}
FORBIDDEN = ("jax", "jaxlib", "flax", "g2o_tpu")


class CellError(RuntimeError):
    """A run that cannot give a result."""


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def find_cell(root, workload):
    """``(bench, cell, config, traffic, end_to_end, per_layer)`` of
    ``workload`` as ``root/BENCHMARK.json`` defines it; the metric lists
    hold the metrics this cell reports."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise CellError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(os.path.join(root, cfg_entry["file"]))
    traffic = load_json(os.path.join(root, "portbench", "traffic",
                                     cell["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    layer = [m for m in bench["per_layer"] if workload in m["workloads"]]
    return bench, cell, config, traffic, e2e, layer


def reader(root, name):
    """The ``read(ctx)`` function of metric ``name``."""
    path = os.path.join(root, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def build_program(config, scene, x0, device):
    """The port's problem and solver for ``scene``, built from arrays."""
    import g2o_tpu_torch
    from g2o_tpu_torch.core.problem import build_problem
    from g2o_tpu_torch.ops import robust
    from g2o_tpu_torch.types.bal import EdgeObservationBAL, VertexCameraBAL
    from g2o_tpu_torch.types.slam3d import VertexPointXYZ

    C, P = x0[0].shape[0], x0[1].shape[0]
    obs = scene.obs
    O = len(obs.cam)
    delta = float(config["huber_delta"])
    host = lambda t: t.detach().cpu().numpy()   # noqa: E731
    vertex_blocks = {
        VertexCameraBAL.name: (np.arange(C), host(x0[0]).astype(np.float64),
                               np.zeros(C, bool), np.zeros(C, bool)),
        VertexPointXYZ.name: (C + np.arange(P),
                              host(x0[1]).astype(np.float64),
                              np.zeros(P, bool), np.ones(P, bool)),
    }
    vids = np.stack([host(obs.cam), C + host(obs.pt)], axis=1)
    edge_blocks = {EdgeObservationBAL.name: (
        vids, host(obs.uv).astype(np.float64),
        np.broadcast_to(np.eye(2), (O, 2, 2)),
        np.full(O, robust.HUBER), np.full(O, delta), np.ones(O, bool),
        np.zeros((O, 0)))}
    problem = build_problem(vertex_blocks, edge_blocks,
                            dtype=DTYPES[config["dtype"]], device=device,
                            **config.get("problem", {}))
    s = config["solver"]
    solver = getattr(g2o_tpu_torch, s["class"])(**s.get("kwargs", {}))
    solver.setup(problem)
    # the problem's own point order (a bucketed build reorders points)
    nat_of_int = np.empty(P, np.int64)
    for vid, (t, i) in problem.vid_index.items():
        if t == VertexPointXYZ.name:
            nat_of_int[i] = vid - C
        elif vid != i:
            raise CellError("cameras out of their id order")
    nat_of_int = torch.as_tensor(nat_of_int, device=device)
    order = SimpleNamespace(cam=VertexCameraBAL.name, pt=VertexPointXYZ.name,
                            nat_of_int=nat_of_int,
                            int_of_nat=torch.argsort(nat_of_int))
    return problem, solver, order


class Instrument:
    """Spans around the calls into each layer, and the trials of the jobs
    under judgement, put on the instances a run built."""

    def __init__(self, problem, solver, tracing):
        self.tracing = tracing
        self.current = None           # trials of the job being recorded
        self.lin_x = {}
        lin = problem.linearize_fn
        stateful = getattr(solver, "_solve_state_fn", None)

        def linearize_fn(data, est):
            with self.span("lm.linearize"):
                out = lin(data, est)
            if self.current is not None:
                self.lin_x[id(out)] = est
            return out

        problem.linearize_fn = linearize_fn
        if stateful is not None:
            def solve_state_fn(data, lin_, lam, state):
                with self.span("lm.solve"):
                    dx, state, st = stateful(data, lin_, lam, state)
                self._trial(lin_, lam, dx, st.get("cg_iterations", 0))
                return dx, state, st

            solver._solve_state_fn = solve_state_fn
        else:
            plain = solver._solve_fn

            def solve_fn(data, lin_, lam, aux):
                with self.span("lm.solve"):
                    dx = plain(data, lin_, lam, aux)
                self._trial(lin_, lam, dx, 0)
                return dx

            solver._solve_fn = solve_fn

    def span(self, name):
        if self.tracing:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def _trial(self, lin, lam, dx, n_cg):
        if self.current is not None:
            self.current.append((self.lin_x[id(lin)], float(lam), dx,
                                 int(n_cg)))


def to_record(problem, order, x0, trials, final, res):
    """A :class:`JobRecord` in natural order of what a job produced
    (``res``: what ``optimize_fused`` returned)."""
    seen = {}

    def natural(est):
        key = id(est[order.pt])
        if key not in seen:
            seen[key] = (est[order.cam], est[order.pt][order.int_of_nat])
        return seen[key]

    rec = JobRecord(x0)
    for est, lam, dx, n_cg in trials:
        blocks = problem.split_tangent(dx)
        rec.trial(natural(est), lam,
                  (blocks[order.cam], blocks[order.pt][order.int_of_nat]),
                  n_cg)
    rec.finish(natural(final), res["chi2_final"], res["lambda_final"])
    return rec


def run_cell(root, workload, seed, seconds, tracing, device="cuda",
             t_start=None):
    """One run; returns the result dict (the run's last line)."""
    t_start = time.perf_counter() if t_start is None else t_start
    _, cell, config, traffic, e2e, layer = find_cell(root, workload)
    readers = {m["name"]: reader(root, m["name"])
               for m in (layer if tracing else e2e)}
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and (not torch.cuda.is_available()
                 or torch.cuda.device_count() < cell["chips"]):
        raise CellError(f"{cell['chips']} CUDA device(s) needed")
    import g2o_tpu_torch

    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    marks = [("start", t_start), ("imports", time.perf_counter())]
    scene = scene_mod.make_scene(config, seed, dev)
    sync()
    marks.append(("scene", time.perf_counter()))
    problem, solver, order = build_program(
        config, scene, scene_mod.job_start(scene, traffic, -1), dev)
    marks.append(("build", time.perf_counter()))
    inst = Instrument(problem, solver, tracing)
    iters = int(traffic["lm_iterations"])

    def job(j, record=False):
        with inst.span("job.draw"):
            x0 = scene_mod.job_start(scene, traffic, j)
            problem.set_estimates({order.cam: x0[0],
                                   order.pt: x0[1][order.nat_of_int]})
        inst.current = [] if record else None
        inst.lin_x.clear()
        res = g2o_tpu_torch.optimize_fused(problem, solver, iters)
        sync()
        trials, inst.current = inst.current, None
        return res, (x0, trials, problem.estimates, res) if record else None

    job(-1)                                    # builds and warms every shape
    marks.append(("warm job", time.perf_counter()))
    print("set-up s: " + ", ".join(
        f"{name} {b - a:.2f}" for (_, a), (name, b) in zip(marks, marks[1:])),
        file=sys.stderr)
    # judged: jobs drawn among the first, and places in the cycle through
    # the pool whose jobs are recorded in every cycle, the last cycle's kept
    rng = np.random.default_rng(int(seed) % (1 << 63))
    pool = int(traffic["start_pool"])
    judged = set(rng.choice(int(traffic["check_among_first"]),
                            int(traffic["check_jobs"]),
                            replace=False).tolist())
    places = set(rng.choice(pool, int(traffic["check_in_last_cycle"]),
                            replace=False).tolist())
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    gc.collect()
    prof = None
    if tracing:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    results, records, last = [], {}, {}
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    with inst.span(trace_mod.WINDOW):
        while True:
            j = len(results)
            if j % pool == 0:
                last.clear()
            res, rec = job(j, record=j in judged or j % pool in places)
            results.append(res)
            if rec is not None:
                (records if j in judged else last)[j] = rec
            # whole cycles of the pool of starts: every seed's window holds
            # the same work
            if (time.perf_counter() - t0 >= seconds
                    and len(results) % pool == 0):
                break
    window_s = time.perf_counter() - t0
    summary = None
    if prof is not None:
        prof.__exit__(None, None, None)
        summary = trace_mod.summarize(trace_mod.kineto_events(prof), SPANS)
        del prof
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    # the program's state goes before the reference runs
    records.update(last)
    recs = {j: to_record(problem, order, *r) for j, r in records.items()}
    del job, problem, solver, inst, records, last
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    obs = scene.obs
    C, P, O = config["cameras"], config["points"], config["observations"]
    k = scene.track
    ctx = SimpleNamespace(
        config=config, traffic=traffic, workload=workload, jobs=results,
        window_s=window_s, setup_s=setup_s, trace=summary, work=work,
        device_name=torch.cuda.get_device_name(dev) if cuda else None,
        window_peak_bytes=window_peak,
        sizes=dict(C=C, P=P, O=O,
                   unordered_pairs=int(torch.sum(k * (k + 1) // 2))),
        span_device_ms=lambda span: _span_device_ms(summary, span))
    metrics = {}
    for m in (layer if tracing else e2e):
        v = readers[m["name"]](ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    failed = sum(1 for r in results if not math.isfinite(r["chi2_final"]))
    limits = config["check_limits"]
    worst = {name: 0.0 for name in limits}
    for j in sorted(recs):
        gaps = judge(recs[j], obs, float(config["huber_delta"]),
                     config["reference_solver"], iters)
        for name in worst:
            worst[name] = max(worst[name], gaps[name])
    correct = (failed == 0 and bool(recs)
               and all(worst[n] <= limits[n] for n in limits))
    out = {"correct": correct, "attempted": len(results), "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": ctx.device_name or "cpu",
                      "count": 1 if cuda else 0,
                      "memory_peak_bytes": int(max(setup_peak, window_peak))}}
    if summary is not None:
        out["device"].update(busy_s=summary.busy_s,
                             window_s=summary.window_s)
        out["breakdown"] = {"device_ops": summary.device_ops,
                            "idle_gaps": summary.idle_gaps}
    out["checks"] = {n: {"value": worst[n], "limit": limits[n]}
                     for n in limits}
    return out


def _span_device_ms(summary, span):
    """Device ms per call of ``span`` in the trace, or None."""
    if summary is None or not summary.span_calls.get(span) \
            or span not in summary.span_device_s:
        return None
    return 1e3 * summary.span_device_s[span] / summary.span_calls[span]


def forbidden_modules():
    """Top-level module names loaded in this process that the run must
    not load."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))
