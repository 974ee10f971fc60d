"""The plain reference against the port at float64 on a tiny scene: the
linearization and the step of both solvers."""

import pytest
import torch

import _tiny
from portbench import bench
from portbench import scene as scene_mod
from portbench.reference.bal import Arith, chi2, linearize
from portbench.reference.check import F64
from portbench.reference.schur import Reduced, direct, pcg

F64_CFG = dict(dtype="float64")


def _program(name):
    cfg = _tiny.config(name, **F64_CFG)
    scene = scene_mod.make_scene(cfg, _tiny.SEED, "cpu")
    x0 = scene_mod.job_start(scene, _tiny.traffic(), 0)
    problem, solver, order = bench.build_program(cfg, scene, x0, "cpu")
    return cfg, scene, x0, problem, solver, order


def _natural(problem, order, blocks):
    return blocks[order.cam], blocks[order.pt][order.int_of_nat]


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


@pytest.mark.parametrize("name", ["bal-venice-1778", "bal-dubrovnik-356"])
def test_linearization_and_step_match_the_port(name):
    cfg, scene, x0, problem, solver, order = _program(name)
    delta = cfg["huber_delta"]
    x = tuple(v.to(F64) for v in x0)
    ref = linearize(x, scene.obs, delta)
    lin = problem.linearize_fn(problem.data, problem.estimates)
    assert abs(float(lin.chi2_robust) - float(ref.chi2)) <= 1e-12 * float(
        ref.chi2)
    assert abs(float(chi2(x, scene.obs, delta)) - float(ref.chi2)) <= \
        1e-12 * float(ref.chi2)
    bc, bp = _natural(problem, order, problem.split_tangent(lin.b))
    assert _rel(bc, ref.bc) < 1e-10 and _rel(bp, ref.bp) < 1e-10
    Hc, Hp = _natural(problem, order, lin.diag)
    assert _rel(Hc, ref.Hc) < 1e-10 and _rel(Hp, ref.Hp) < 1e-10

    lam = 1e-3 * float(Hc.diagonal(dim1=1, dim2=2).abs().max())
    red = Reduced(ref, lam, scene.obs, Arith(F64))
    if cfg["reference_solver"]["kind"] == "pcg":
        dx, _, st = solver._solve_state_fn(problem.data, lin, lam,
                                           solver.state0)
        dxc, it, _ = pcg(red, n=st["cg_iterations"])
        assert it == st["cg_iterations"] > 0
    else:
        dx = solver._solve_fn(problem.data, lin, lam, solver.aux)
        dxc = direct(red)
    pc, pp = _natural(problem, order, problem.split_tangent(dx))
    assert _rel(pc, dxc) < 1e-8
    assert _rel(pp, red.points(dxc)) < 1e-8
