"""The port's program spans (``utils/tictoc.py::span``) on the benchmark's
path, on the CPU: off, they enter no profiler range and cost nothing
else; on, they change no result bit, and under ``torch.profiler`` their
counts follow the LM loop's result dict — trials, CG iterations, every
host read by site, each solver stage once a solve inside its solve span;
with ``G2O_ENABLE_TICTOC`` set they accumulate in ``tictoc.stats()``."""

import io
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import g2o_tpu_torch
from g2o_tpu_torch.io import bal as tbal
from g2o_tpu_torch.utils import tictoc

ITERS = 10
STAGES = {
    "ImplicitSchurSolver": ("schur_implicit", (
        "landmark_system", "reduced_rhs", "preconditioner", "cg",
        "back_substitute")),
    "SchurSolver": ("schur", ("reduce", "pairs", "factor",
                              "back_substitute")),
}
SOLVERS = {
    # the benchmark's two solvers: the implicit one on the dims-major
    # (landmark-bucketed) layout, the explicit one summing pairs with K4
    "ImplicitSchurSolver": (True, dict(max_iter=100, tol=1e-2)),
    "SchurSolver": (False, dict(use_pallas=True)),
}


@pytest.fixture(scope="module")
def scene_text():
    return tbal.make_stress_bal(n_cameras=6, n_points=80,
                                mean_obs_per_point=4, seed=4)


@pytest.fixture
def fresh_stats(monkeypatch):
    monkeypatch.delenv("G2O_ENABLE_TICTOC", raising=False)
    monkeypatch.setattr(tictoc, "_STATS", {})


def _run(text, solver_name):
    """``(result dict, final estimates)`` of ``ITERS`` LM iterations on the
    scene, a fresh problem and solver each call."""
    bucket, kw = SOLVERS[solver_name]
    problem = tbal.load_bal_problem(io.StringIO(text), huber=1.0,
                                    dtype=torch.float32, device="cpu",
                                    bucket_landmarks=bucket)
    solver = getattr(g2o_tpu_torch, solver_name)(**kw)
    res = g2o_tpu_torch.optimize_fused(problem, solver, ITERS)
    return res, problem.estimates


def _reads(res, solver_name):
    """Host reads ``optimize_fused`` makes: λ₀ and the first chi2, chi2 an
    iteration, chi2 and the gain a trial and, in the implicit solver, a
    stop test a CG iteration, the one that ends each solve, and the
    preconditioner's Cholesky inverse a solve."""
    n_iter = res["iterations"]
    trials = sum(res["trials_per_iteration"])
    cg = sum(res["cg_per_iteration"])
    out = 2 + n_iter + 2 * trials
    if solver_name == "ImplicitSchurSolver":
        out += cg + 2 * trials
    return out


@pytest.mark.parametrize("solver_name", sorted(SOLVERS))
def test_off_enters_no_profiler_range(scene_text, solver_name, fresh_stats,
                                      monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name, *args, **kwargs):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Counting)
    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    assert tictoc.span("lm.trial") is tictoc.span("linearize")
    res, _ = _run(scene_text, solver_name)
    assert res["iterations"] == ITERS
    assert entered == [] and tictoc.stats() == {}


@pytest.mark.parametrize("solver_name", sorted(SOLVERS))
def test_results_bit_equal_with_spans_on(scene_text, solver_name,
                                         fresh_stats, monkeypatch):
    off, est_off = _run(scene_text, solver_name)
    with profile(activities=[ProfilerActivity.CPU]):
        on, est_on = _run(scene_text, solver_name)
    monkeypatch.setenv("G2O_ENABLE_TICTOC", "1")
    timed, est_timed = _run(scene_text, solver_name)
    for res, est in ((on, est_on), (timed, est_timed)):
        for key in ("chi2_per_iteration", "trials_per_iteration",
                    "cg_per_iteration", "chi2_final", "lambda_final",
                    "iterations"):
            assert res[key] == off[key], key
        for t in est_off:
            assert torch.equal(est[t], est_off[t]), t


@pytest.mark.parametrize("solver_name", sorted(SOLVERS))
def test_profiled_spans_follow_the_result(scene_text, solver_name,
                                          fresh_stats):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res, _ = _run(scene_text, solver_name)
    spans = [e for e in prof.events() if e.name.startswith("g2o.")]
    calls = Counter(e.name[len("g2o."):] for e in spans)
    trials = sum(res["trials_per_iteration"])
    cg = sum(res["cg_per_iteration"])
    assert trials > res["iterations"] >= 2       # a rejected trial or more
    assert calls["lm.trial"] == trials
    assert calls["linearize"] == trials + 1
    assert sum(n for k, n in calls.items()
               if k.startswith("read.")) == _reads(res, solver_name)
    assert calls["read.lambda0"] == 1
    assert calls["read.chi2"] == 1 + res["iterations"] + trials
    assert calls["read.gain"] == trials
    prefix, stages = STAGES[solver_name]
    assert calls[prefix + ".solve"] == trials
    for stage in stages:
        assert calls[f"{prefix}.{stage}"] == trials, stage
    if solver_name == "ImplicitSchurSolver":
        assert cg > 0
        assert calls["cg.iter"] == cg
        assert calls["read.cg_stop"] == cg + trials
        assert calls["read.cholesky_inverse"] == trials
    else:
        assert cg == 0 and "cg.iter" not in calls

    def inside(child, parent_name):
        return any(p.name == parent_name and p.thread == child.thread
                   and p.time_range.start <= child.time_range.start
                   and child.time_range.end <= p.time_range.end
                   for p in spans)

    for e in spans:
        name = e.name[len("g2o."):]
        if name.startswith(prefix + ".") and name != prefix + ".solve":
            assert inside(e, f"g2o.{prefix}.solve"), name
        if name in ("cg.iter", "read.cg_stop"):
            assert inside(e, "g2o.schur_implicit.cg"), name
        if name == "read.cholesky_inverse":
            assert inside(e, "g2o.schur_implicit.preconditioner"), name
        if name.endswith(".solve") or name == "read.gain":
            assert inside(e, "g2o.lm.trial"), name
    # the profiled run's spans are in the host timers too
    st = tictoc.stats()
    assert {k: v["count"] for k, v in st.items()} == dict(calls)


@pytest.mark.parametrize("solver_name", sorted(SOLVERS))
def test_tictoc_accumulates_the_spans(scene_text, solver_name, fresh_stats,
                                      monkeypatch):
    monkeypatch.setenv("G2O_ENABLE_TICTOC", "1")
    res, _ = _run(scene_text, solver_name)
    st = tictoc.stats()
    trials = sum(res["trials_per_iteration"])
    assert st["lm.trial"]["count"] == trials
    assert st["linearize"]["count"] == trials + 1
    assert sum(v["count"] for k, v in st.items()
               if k.startswith("read.")) == _reads(res, solver_name)
    prefix, _ = STAGES[solver_name]
    assert st[prefix + ".solve"]["count"] == trials
    assert 0 < st["lm.trial"]["min"] <= st["lm.trial"]["max"]
    # a span inside another takes no more host time than it
    assert st[prefix + ".solve"]["total"] <= st["lm.trial"]["total"]


def test_span_keeps_tictoc_and_exceptions(fresh_stats, monkeypatch):
    with tictoc.span("x"):
        pass
    assert tictoc.stats() == {}
    monkeypatch.setenv("G2O_ENABLE_TICTOC", "1")
    with tictoc.tictoc("key"):
        with tictoc.span("stage"):
            pass
    with pytest.raises(ValueError):
        with tictoc.span("stage"):
            raise ValueError("passes through")
    st = tictoc.stats()
    assert st["key"]["count"] == 1 and st["stage"]["count"] == 2
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tictoc.span("outer"):
            with tictoc.span("inner"):
                torch.ones(2).sum()
    names = [e.name for e in prof.events()]
    assert "g2o.outer" in names and "g2o.inner" in names
