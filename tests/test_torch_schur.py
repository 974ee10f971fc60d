"""Port parity: the explicit Schur solver, the dense solver and the BA slice
end to end, against the JAX package, float64 on the CPU.

The C20 BAL file (20 cameras, 800 points, 4000 observations) is loaded by
each package's ``load_bal_problem``.  Tolerances, each relative to the
largest entry of the reference:
* ``Hschur``, ``bschur`` and ``dx`` against JAX's ``SchurSolver()`` (the
  default ``jax.ops.segment_sum`` route; its ``use_pallas=True`` route has
  no CPU mode): rtol 1e-9 — the same formulas, the pairs summed in another
  order, and a free-gauge system whose condition number reaches ~1e6 at
  λ = 1e-4;
* Schur against the dense solve (algebraically exact): rtol 1e-8;
* the 10-iteration fused-LM chi2 trajectory: rtol 1e-8, with the same
  trials per iteration.
"""

import gzip
import io
import os

import numpy as np
import pytest
import torch

import g2o_tpu.types  # noqa: F401
from g2o_tpu.core.lm_fused import optimize_fused as j_optimize_fused
from g2o_tpu.core.solvers import DenseSolver as JDense
from g2o_tpu.core.solvers import SchurSolver as JSchur
from g2o_tpu.io import bal as jbal
import g2o_tpu_torch
from g2o_tpu_torch.core.solvers.schur import _observation_pairs
from g2o_tpu_torch.io import bal as tbal
from g2o_tpu_torch.ops import segment_kernels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C20 = os.path.join(ROOT, "data", "bal_cache", "bal-C20-P800-K5-N1-S0.txt.gz")
RTOL = 1e-9


def _close(a, b, rtol=RTOL):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


@pytest.fixture(scope="module")
def text():
    with gzip.open(C20, "rt") as fh:
        return fh.read()


def _pair(text, **kw):
    return (jbal.load_bal_problem(io.StringIO(text), **kw),
            tbal.load_bal_problem(io.StringIO(text), device="cpu", **kw))


@pytest.fixture(scope="module")
def linearized(text):
    jp, tp = _pair(text)
    return (jp, tp, jp.linearize_jit(jp.data, jp.estimates),
            tp.linearize_fn(tp.data, tp.estimates))


@pytest.mark.parametrize("lam", [1e-4, 1.0])
def test_reduced_system_and_step_match_jax(linearized, lam):
    jp, tp, jl, tl = linearized
    js = JSchur().setup(jp)
    ts = g2o_tpu_torch.SchurSolver(use_pallas=True).setup(tp)
    jH, jb, jB, jD = js._reduced_parts_fn(jp.data, jl, lam, js.aux)
    tH, tb, tB, tD = ts._reduced_parts_fn(tp.data, tl, lam, ts.aux)
    assert tH.shape == (180, 180)
    _close(tH, jH)
    _close(tb, jb)
    _close(tB, jB)
    _close(tD, jD)
    _close(ts.solve(tp.data, tl, lam), js.solve(jp.data, jl, lam))


def test_layout_and_pattern_match_jax(linearized):
    jp, tp, _, _ = linearized
    js = JSchur().setup(jp)
    ts = g2o_tpu_torch.SchurSolver().setup(tp)
    for k in ("pose_base", "lm_base", "Tp", "NL", "dp", "dl", "marg"):
        assert ts._layout[k] == js._layout[k], k
    assert ts._layout["n_pairs"] == 800 * 25
    np.testing.assert_array_equal(ts.aux["pose_to_global"].numpy(),
                                  np.asarray(js.aux["pose_to_global"]))
    np.testing.assert_array_equal(ts.aux["lm_idx2"][:, 0].numpy(),
                                  np.asarray(js.aux["lm_goff"]))
    # the same (pair, camera block) multiset; the port's pairs are sorted
    # by segment, with the segment ids of the JAX package's np.unique
    def triples(a, b, seg):
        return sorted(zip(np.asarray(a).tolist(), np.asarray(b).tolist(),
                          np.asarray(seg).tolist()))
    assert triples(ts.aux["pairs_a"], ts.aux["pairs_b"], ts.aux["pair_seg"]) \
        == triples(js.aux["pairs_a"], js.aux["pairs_b"], js.aux["pair_seg"])
    seg = ts.aux["pair_seg"].numpy()
    assert (np.diff(seg) >= 0).all()
    assert seg.max() + 1 == 20 * 20


def test_observation_pairs_order():
    a, b = _observation_pairs(np.array([5, 2, 5, 2, 9]))
    assert list(zip(a.tolist(), b.tolist())) == [
        (1, 1), (1, 3), (3, 1), (3, 3), (0, 0), (0, 2), (2, 0), (2, 2),
        (4, 4)]


def test_pallas_route_matches_plain_route(linearized):
    """On CPU tensors both routes take K4's plain version: equal bits."""
    _, tp, _, tl = linearized
    a = g2o_tpu_torch.SchurSolver(use_pallas=True).setup(tp)
    b = g2o_tpu_torch.SchurSolver(use_pallas=False).setup(tp)
    assert torch.equal(a.solve(tp.data, tl, 1e-3), b.solve(tp.data, tl, 1e-3))


@pytest.mark.parametrize("fix_first_camera", [False, True])
@pytest.mark.parametrize("lam", [1e-4, 1.0])
def test_schur_matches_dense(text, lam, fix_first_camera):
    """Schur elimination gives the dense solve's step (algebraically
    exact); a fixed camera does not move."""
    _, tp = _pair(text, fix_first_camera=fix_first_camera)
    tl = tp.linearize_fn(tp.data, tp.estimates)
    dx_s = g2o_tpu_torch.SchurSolver().setup(tp).solve(tp.data, tl, lam)
    dx_d = g2o_tpu_torch.DenseSolver().setup(tp).solve(tp.data, tl, lam)
    _close(dx_s, dx_d, rtol=1e-8)
    if fix_first_camera:
        assert torch.equal(dx_s[:9], torch.zeros(9, dtype=dx_s.dtype))


def test_dense_solver_and_hessian_match_jax(text):
    jp, tp = _pair(text, fix_first_camera=True, huber=1.0)
    jl = jp.linearize_jit(jp.data, jp.estimates)
    tl = tp.linearize_fn(tp.data, tp.estimates)
    _close(tp.dense_hessian_fn(tp.data, tl), jp.dense_hessian_fn(jp.data, jl))
    lam = 1e-3
    _close(g2o_tpu_torch.DenseSolver().setup(tp).solve(tp.data, tl, lam),
           JDense().setup(jp).solve(jp.data, jl, lam))


def test_dense_solver_not_positive_definite_gives_nan(linearized):
    """An indefinite system is a NaN step (the LM trial is rejected), not
    an exception."""
    _, tp, _, tl = linearized
    dx = g2o_tpu_torch.DenseSolver().setup(tp).solve(tp.data, tl, -1e9)
    assert torch.isnan(dx).all()
    dx = g2o_tpu_torch.SchurSolver().setup(tp).solve(tp.data, tl, -1e9)
    assert torch.isnan(dx).any()


@pytest.mark.parametrize("huber", [0.0, 1.0])
def test_fused_lm_trajectory_matches_jax(text, huber):
    jp, tp = _pair(text, huber=huber)
    jres = j_optimize_fused(jp, JSchur(), 10)
    before = segment_kernels.segment_sum.launches
    tres = g2o_tpu_torch.optimize_fused(
        tp, g2o_tpu_torch.SchurSolver(use_pallas=True), 10)
    assert segment_kernels.segment_sum.launches == before   # CPU: plain
    assert tres["iterations"] == jres["iterations"] == 10
    np.testing.assert_allclose(tres["chi2_per_iteration"],
                               jres["chi2_per_iteration"], rtol=1e-8)
    np.testing.assert_allclose(tres["chi2_final"], jres["chi2_final"],
                               rtol=1e-8)
    assert tres["trials_per_iteration"] == jres["trials_per_iteration"]
    assert tres["chi2_final"] < 0.8 * tres["chi2_per_iteration"][0]
    for t in jp.vertex_types:
        _close(tp.estimates[t], jp.estimates[t], rtol=1e-6)


def test_host_loop_lm_matches_fused(text):
    """SparseOptimizer + LevenbergMarquardt and optimize_fused implement the
    same rules: with the stateless Schur solve their trajectories agree."""
    _, tp = _pair(text, huber=1.0)
    est0 = {t: v.clone() for t, v in tp.estimates.items()}
    opt = g2o_tpu_torch.SparseOptimizer(
        tp, algorithm=g2o_tpu_torch.LevenbergMarquardt(),
        solver=g2o_tpu_torch.SchurSolver())
    opt.optimize(5)
    host = [s.chi2 for s in opt.batch_statistics]
    host_final = opt.chi2()
    tp.set_estimates(est0)
    res = g2o_tpu_torch.optimize_fused(tp, g2o_tpu_torch.SchurSolver(), 5)
    np.testing.assert_allclose(res["chi2_per_iteration"], host, rtol=1e-10)
    np.testing.assert_allclose(res["chi2_final"], host_final, rtol=1e-10)


def test_sparse_optimizer_defaults_to_dense(linearized):
    _, tp, _, _ = linearized
    opt = g2o_tpu_torch.SparseOptimizer(tp)
    assert isinstance(opt.solver, g2o_tpu_torch.DenseSolver)


def test_partial_marginalization_raises(text):
    g = tbal.load_bal(io.StringIO(text))
    g.set_marginalized(20, False)           # the first point
    p = g.compile(device="cpu")
    assert not p.marginalized["VERTEX_TRACKXYZ"][0]
    with pytest.raises(NotImplementedError, match="partially"):
        g2o_tpu_torch.SchurSolver().setup(p)


def test_entry_points_default_to_the_card(text):
    """Without ``device`` the problem is built on the CUDA card; with no
    card that raises instead of moving to the CPU quietly."""
    g = tbal.load_bal(io.StringIO(text))
    if torch.cuda.is_available():
        assert g.compile().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        g.compile()
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tbal.load_bal_problem(io.StringIO(text))


def test_symchol_copy_is_identical():
    """The port builds its own copy of the JAX package's symbolic-analysis
    source; the two files stay byte-identical."""
    with open(os.path.join(ROOT, "g2o_tpu", "native", "symchol.cpp"),
              "rb") as fh:
        want = fh.read()
    with open(os.path.join(ROOT, "g2o_tpu_torch", "native", "symchol.cpp"),
              "rb") as fh:
        assert fh.read() == want
