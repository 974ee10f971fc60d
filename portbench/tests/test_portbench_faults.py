"""A run with the timed path broken underneath judges itself not correct:
a step that leaves the state unchanged, half the observations left out
(the rest weighted double, as a mean over them), an estimate altered where
it is produced (each LM update's, or the returned answer), and the faults
of ``portbench/faults.py`` (damping, CG stop, LM iterations, chi2), also
late in the window.  One chip, so no exchange between chips to leave out.
The run skips only the look for a card."""

import json
import os

import numpy as np
import pytest

import _tiny
import g2o_tpu_torch
from g2o_tpu_torch.core import problem as problem_mod
from portbench import bench, faults

CELLS = ["venice1778.cold", "dubrovnik356.cold"]
STEP = {"venice1778.cold": "step_gap", "dubrovnik356.cold": "backward_error"}
# the number each planted fault has to fail
CAUGHT_BY = {"lambda0_x10": "lambda_gap", "cg_tol_x2": "cg_stop",
             "lm_one_short": "iterations_gap", "answer_altered": "path_gap",
             "chi2_stale": "chi2_gap"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _tiny.make_root(tmp_path_factory.mktemp("faults"))


def _run(root, cell):
    return bench.run_cell(root, cell, _tiny.SEED, 0.0, False, "cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    out = _run(root, cell)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_state_left_unchanged(root, cell, monkeypatch):
    build = bench.build_program

    def broken(*a, **k):
        problem, solver, order = build(*a, **k)
        problem.apply_update_fn = lambda data, est, dx: est
        return problem, solver, order

    monkeypatch.setattr(bench, "build_program", broken)
    out = _run(root, cell)
    assert not out["correct"]
    check = out["checks"]["path_gap"]
    assert check["value"] > check["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_observations_left_out(root, cell, monkeypatch):
    build = problem_mod.build_problem

    def broken(vertex_blocks, edge_blocks, **k):
        halved = {}
        for name, (vids, meas, info, kern, delta, act, par) in \
                edge_blocks.items():
            act = np.array(act)
            act[::2] = False
            info = np.array(info)
            info[1::2] *= 2.0
            halved[name] = (vids, meas, info, kern, delta, act, par)
        return build(vertex_blocks, halved, **k)

    monkeypatch.setattr(problem_mod, "build_problem", broken)
    out = _run(root, cell)
    assert not out["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_each_update_altered(root, cell, monkeypatch):
    build = bench.build_program

    def broken(*a, **k):
        problem, solver, order = build(*a, **k)
        update = problem.apply_update_fn

        def altered(data, est, dx):
            out = dict(update(data, est, dx))
            pts = out[order.pt].clone()
            pts[0] += 0.05
            out[order.pt] = pts
            return out

        problem.apply_update_fn = altered
        return problem, solver, order

    monkeypatch.setattr(bench, "build_program", broken)
    out = _run(root, cell)
    assert not out["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_solver_that_gives_up(root, cell, monkeypatch):
    """A non-finite step is admitted only below float32's resolution of the
    largest diagonal entry; at the start's damping it is a failure."""
    build = bench.build_program

    def broken(*a, **k):
        problem, solver, order = build(*a, **k)
        stateful = getattr(solver, "_solve_state_fn", None)
        if stateful is not None:
            def nan_state(data, lin, lam, state):
                dx, state, st = stateful(data, lin, lam, state)
                return dx * float("nan"), state, st
            solver._solve_state_fn = nan_state
        else:
            plain = solver._solve_fn
            solver._solve_fn = lambda *args: plain(*args) * float("nan")
        return problem, solver, order

    monkeypatch.setattr(bench, "build_program", broken)
    out = _run(root, cell)
    assert not out["correct"]
    assert out["checks"][STEP[cell]]["value"] == float("inf")


@pytest.mark.parametrize("cell", CELLS)
def test_answer_altered(root, cell, monkeypatch):
    run = g2o_tpu_torch.optimize_fused

    def broken(problem, solver, iters, **k):
        res = run(problem, solver, iters, **k)
        est = dict(problem.estimates)
        pts = est["VERTEX_TRACKXYZ"].clone()
        pts[0] += 0.05
        est["VERTEX_TRACKXYZ"] = pts
        problem.set_estimates(est)
        return res

    monkeypatch.setattr(g2o_tpu_torch, "optimize_fused", broken)
    out = _run(root, cell)
    assert not out["correct"]
    assert out["checks"]["path_gap"]["value"] > \
        out["checks"]["path_gap"]["limit"]


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS for f in faults.NAMES
    if f != "cg_tol_x2" or c == "venice1778.cold"])
def test_planted_fault(root, cell, fault, monkeypatch):
    monkeypatch.setattr(g2o_tpu_torch, "optimize_fused",
                        faults.planted(fault, g2o_tpu_torch.optimize_fused))
    out = _run(root, cell)
    assert not out["correct"]
    check = out["checks"][CAUGHT_BY[fault]]
    assert check["value"] > check["limit"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_late_in_the_window(tmp_path, cell, monkeypatch):
    """Answers altered after the jobs judged among the first: the jobs
    recorded in the last cycle through the pool catch them."""
    root = _tiny.make_root(tmp_path)
    path = os.path.join(root, "portbench", "traffic", "cold.json")
    traffic = dict(_tiny.traffic(), start_pool=4, check_in_last_cycle=4)
    with open(path, "w") as f:
        json.dump(traffic, f)
    run, calls = g2o_tpu_torch.optimize_fused, []
    late = faults.planted("answer_altered", run)

    def broken(*a, **k):
        calls.append(1)
        # the warm-up job and the first three of the window run sound
        return (run if len(calls) <= 4 else late)(*a, **k)

    monkeypatch.setattr(g2o_tpu_torch, "optimize_fused", broken)
    out = _run(root, cell)
    assert not out["correct"]
    check = out["checks"]["path_gap"]
    assert check["value"] > check["limit"]
