"""The harness's arithmetic on the CPU: work counts, the trace reduction,
the end-to-end readers, and a cell added as data alone."""

import json
import math
import os
from types import SimpleNamespace

import pytest

import _tiny
from portbench import bench, trace, work

H100 = "NVIDIA H100 80GB HBM3"


def test_implicit_solve_work_by_hand():
    # one camera, one point, one observation: B 27 floats, 1 id, D^-1 9,
    # camera blocks 81, vectors 3 + 9
    assert work.implicit_solve(1, 1, 1, 0) == (928, 2304)
    assert work.implicit_solve(1, 1, 1, 2) == (928 + 2 * 796, 2304 + 2 * 540)


def test_explicit_solve_work_by_hand():
    # two observations, three unordered pairs, S 9 wide (45 in a triangle)
    nbytes, ops = work.explicit_solve(1, 1, 2, 3)
    assert nbytes == 1632
    assert ops == pytest.approx(3000)


def test_least_seconds():
    assert work.least_seconds(3.35e12, 0, H100) == pytest.approx(1.0)
    assert work.least_seconds(0, 67e12, H100) == pytest.approx(1.0)
    assert work.least_seconds(1, 1, "another card") is None


def _events():
    host, ns = 1, 1
    ev = [("window", False, 0, 1000, 1, 0, host),
          ("lm.linearize", False, 100, 300, 2, 0, host),
          ("lm.solve", False, 400, 900, 3, 0, host),
          ("cudaLaunchKernel", False, 150, 160, 11, 0, host),
          ("cudaLaunchKernel", False, 450, 460, 12, 0, host),
          ("aten::mm", False, 420, 430, 99, 0, host),
          ("k1", True, 200, 400, 11, 0, 7),
          ("k2", True, 500, 700, 12, 0, 7),
          ("k3", True, 650, 800, 13, 99, 7),
          ("Stream Sync", True, 800, 950, 14, 0, 7),
          ("lm.solve", True, 410, 905, 16, 0, 7),
          ("window", True, 5, 999, 17, 0, 7),
          ("k4", True, 990, 1100, 15, 0, 7)]
    return ev, ns


def test_trace_summary_over_synthetic_intervals():
    ev, _ = _events()
    s = trace.summarize(ev, ("lm.linearize", "lm.solve"))
    assert s.window_s == pytest.approx(1e-6)
    # k1 [200, 400] and k2 u k3 [500, 800]; the sync record and k4 (past
    # the window) and the spans' own device records are not work in it
    assert s.busy_s == pytest.approx(500e-9)
    assert s.span_calls == {"lm.linearize": 1, "lm.solve": 1}
    assert s.span_device_s["lm.linearize"] == pytest.approx(200e-9)
    assert s.span_device_s["lm.solve"] == pytest.approx(350e-9)
    idle = dict(s.idle_gaps)
    assert idle == pytest.approx({"lm.linearize": 200e-9,
                                  "lm.solve/cudaLaunchKernel": 100e-9,
                                  "lm.solve": 200e-9})
    assert s.device_ops[0][0] == "k1" and s.kernels == 3
    ctx = SimpleNamespace(trace=s)
    read = bench.reader(_tiny.ROOT, "idle_share")
    assert read(ctx) == pytest.approx(50.0)


def test_end_to_end_readers():
    ctx = SimpleNamespace(window_s=12.0, setup_s=3.5, jobs=[{}] * 4)
    assert bench.reader(_tiny.ROOT, "solve_s")(ctx) == pytest.approx(3.0)
    assert bench.reader(_tiny.ROOT, "setup_s")(ctx) == 3.5
    jobs = [{"iterations": 10, "trials_per_iteration": [1] * 9 + [3],
             "cg_per_iteration": [5] * 10}]
    ctx = SimpleNamespace(jobs=jobs, config={"solve_layer": "implicit"})
    assert bench.reader(_tiny.ROOT, "lm_trials_per_iter")(ctx) == 1.2
    assert bench.reader(_tiny.ROOT, "cg_iters_per_solve")(ctx) == \
        pytest.approx(50 / 12)
    ctx.config = {"solve_layer": "explicit"}
    assert bench.reader(_tiny.ROOT, "cg_iters_per_solve")(ctx) is None


def test_a_new_cell_is_data_alone(tmp_path):
    root = _tiny.make_root(tmp_path)
    pb = os.path.join(root, "portbench")
    cfg = _tiny.config("bal-dubrovnik-356", name="tiny-throwaway")
    cfg["scene"]["depth_sigma"] = 0.3
    with open(os.path.join(pb, "configs", "tiny-throwaway.json"), "w") as f:
        json.dump(cfg, f)
    traffic = dict(_tiny.traffic(), lm_iterations=3,
                   point_sigma_per_depth=0.01, start_pool=3)
    with open(os.path.join(pb, "traffic", "warm.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(pb, "metrics", "jobs_done.py"), "w") as f:
        f.write("def read(ctx):\n    return len(ctx.jobs)\n")
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        b = json.load(f)
    b["configs"].append(dict(name="tiny-throwaway", source="a test",
                             file="portbench/configs/tiny-throwaway.json",
                             reduced=[], why="a test"))
    b["workloads"].append(dict(name="throwaway.warm", config="tiny-throwaway",
                               traffic="warm", chips=1, why="a test"))
    b["per_layer"].append(dict(name="jobs_done", unit="jobs",
                               better="higher", source="program_counter",
                               layer="LM control", moves="solve_s",
                               workloads=["throwaway.warm"]))
    with open(path, "w") as f:
        json.dump(b, f)
    out = bench.run_cell(root, "throwaway.warm", 7, 0.0, False, "cpu")
    assert set(out["metrics"]) == {"solve_s", "setup_s"}
    assert out["correct"] and out["attempted"] == 3
    out = bench.run_cell(root, "throwaway.warm", 7, 0.0, True, "cpu")
    assert out["metrics"]["jobs_done"]["value"] == 3
    assert "idle_share" not in out["metrics"]
    assert math.isfinite(out["checks"]["backward_error"]["value"])
