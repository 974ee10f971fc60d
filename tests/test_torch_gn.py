"""Port parity on the manhattan path: ``PCGSolver``'s ``every_k`` and
``frozen`` preconditioner modes, ``optimize_fused_gn``, the whole-run
functions ``make_lm_run`` / ``make_gn_run`` (their tuples and padded
histories), ``GaussNewton`` and the hybrid ``HostCholSolver`` /
``optimize_gn_host``, against the JAX package, float64 on the CPU.

The graph is ``create_manhattan(n_poses=300, seed=0)``.  With
``chunk_size=8`` its chunk2 coarse level has 38 chunks × 3 = 114 columns,
padded to 192: the K1/K2 dispatch (their plain versions here) is on the
path of the ``every_k`` runs.  The frozen and GN runs take bench.py's
chunks of 16: with 8, their long CG solves on this ill-conditioned
system (κ ~1e9 before preconditioning) carry summation-order differences
to ~1e-8 in a solve.  Chi2 trajectories agree to rtol 1e-9 and CG counts
exactly; a host Cholesky step's dx to rtol 1e-10."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import g2o_tpu.types  # noqa: F401
import g2o_tpu_torch as tg2o
from g2o_tpu.core.graph import Graph as JGraph
from g2o_tpu.core.lm_fused import optimize_fused as j_optimize_fused
from g2o_tpu.core.lm_fused import make_gn_run as j_make_gn_run
from g2o_tpu.core.lm_fused import make_lm_run as j_make_lm_run
from g2o_tpu.core.lm_fused import optimize_fused_gn as j_optimize_fused_gn
from g2o_tpu.core.optimizer import GaussNewton as JGaussNewton
from g2o_tpu.core.optimizer import SparseOptimizer as JSparseOptimizer
from g2o_tpu.core.solvers import PCGSolver as JPCG
from g2o_tpu.core.solvers.host_chol import HostCholSolver as JHostChol
from g2o_tpu.core.solvers.host_chol import optimize_gn_host as j_gn_host
from g2o_tpu.sim.generators import create_manhattan
from g2o_tpu.types import slam2d as jslam2d
from g2o_tpu_torch.core.lm_fused import make_gn_run as t_make_gn_run
from g2o_tpu_torch.core.lm_fused import make_lm_run as t_make_lm_run
from g2o_tpu_torch.core.solvers.pcg import PCGSolver as TPCG
from g2o_tpu_torch.types import slam2d as tslam2d
from test_torch_problem import port_problem

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-9


@pytest.fixture(scope="module")
def graph():
    return create_manhattan(n_poses=300, seed=0)


def _pair(graph):
    jp = graph.compile()
    return jp, port_problem(jp)


def _fast(chunk_size=8, **kw):
    """bench.py's phase-1 solver, chunks of 8 (bench.py's 16 gives one
    96-column coarse panel at 300 poses, off the K1/K2 dispatch)."""
    return dict(max_iter=32, tol=1e-2, precond="chunk2",
                chunk_size=chunk_size, **kw)


def _assert_same_run(tres, jres):
    assert tres["iterations"] == jres["iterations"]
    np.testing.assert_allclose(tres["chi2_per_iteration"],
                               jres["chi2_per_iteration"], rtol=RTOL)
    np.testing.assert_allclose(tres["chi2_final"], jres["chi2_final"],
                               rtol=RTOL)
    assert list(tres["cg_per_iteration"]) == list(jres["cg_per_iteration"])


# --------------------------------------------------------------------------- #
# precond_mode
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("K", [1, 8])
def test_every_k_lm_matches_jax(graph, K):
    jp, tp = _pair(graph)
    kw = _fast(precond_mode="every_k", precond_refresh_every=K)
    jres = j_optimize_fused(jp, JPCG(**kw), 15)
    ts = TPCG(**kw)
    tres = tg2o.optimize_fused(tp, ts, 15)
    _assert_same_run(tres, jres)
    # the state: k counts every λ-trial, rejected ones included
    assert ts.state0["k"] == 0
    if K == 1:
        # a refresh on every solve is the per-solve preconditioner
        _, tp2 = _pair(graph)
        _assert_same_run(tg2o.optimize_fused(tp2, TPCG(**_fast()), 15), tres)


def test_every_k_solve_state_counts_trials(graph):
    """``k`` is a host int; the preconditioner is rebuilt when k % K == 0
    and carried otherwise."""
    _, tp = _pair(graph)
    ts = TPCG(**_fast(precond_mode="every_k", precond_refresh_every=3))
    ts.setup(tp)
    lin = tp.linearize_fn(tp.data, tp.estimates)
    state, minvs = ts.state0, []
    for _ in range(4):
        _, state, _ = ts._solve_state_fn(tp.data, lin, 1.0, state)
        minvs.append(state["minv"])
    assert isinstance(state["k"], int) and state["k"] == 4
    assert minvs[1] is minvs[0] and minvs[2] is minvs[0]
    assert minvs[3] is not minvs[0]


def test_frozen_lm_matches_jax(graph):
    """``frozen``: set up (a refresh at 1e-5·max|H_jj|), then refreshed
    explicitly at λ = 1e-3 before the run, in both packages."""
    jp, tp = _pair(graph)
    kw = _fast(chunk_size=16, precond_mode="frozen")
    js, ts = JPCG(**kw), TPCG(**kw)
    js.setup(jp).refresh_precond(jp, lam=1e-3)
    ts.setup(tp).refresh_precond(tp, lam=1e-3)
    _assert_same_run(tg2o.optimize_fused(tp, ts, 15),
                     j_optimize_fused(jp, js, 15))


def test_refresh_precond_needs_frozen_mode():
    with pytest.raises(RuntimeError):
        TPCG(precond="chunk2", precond_mode="every_k").refresh_precond()


def test_unknown_precond_mode_raises():
    with pytest.raises(ValueError):
        TPCG(precond="chunk2", precond_mode="sometimes")


def test_every_k_jacobi_lm_matches_jax(graph):
    """``every_k`` also gates a one-level preconditioner, as in JAX."""
    jp, tp = _pair(graph)
    kw = dict(max_iter=32, tol=1e-2, precond="jacobi",
              precond_mode="every_k", precond_refresh_every=4)
    _assert_same_run(tg2o.optimize_fused(tp, TPCG(**kw), 10),
                     j_optimize_fused(jp, JPCG(**kw), 10))


# --------------------------------------------------------------------------- #
# Gauss-Newton
# --------------------------------------------------------------------------- #

def test_fused_gn_matches_jax(graph):
    """bench.py's polish solver (deep chunk2 CG, carry_factor 0.01), 6 GN
    iterations after 5 LM iterations."""
    jp, tp = _pair(graph)
    j_optimize_fused(jp, JPCG(**_fast()), 5)
    tg2o.optimize_fused(tp, TPCG(**_fast()), 5)
    kw = dict(max_iter=128, tol=1e-6, precond="chunk2", chunk_size=16,
              carry_factor=0.01, matvec_precision="highest")
    _assert_same_run(tg2o.optimize_fused_gn(tp, TPCG(**kw), 6),
                     j_optimize_fused_gn(jp, JPCG(**kw), 6))


def _runner_state(solver, dtype):
    """The solver state a JAX runner is called with (``optimize_fused``'s
    choice): the solver's ``state0``, else a placeholder zero."""
    st = getattr(solver, "state0", None)
    if st is None or not hasattr(solver, "_solve_state_fn"):
        st = jnp.zeros((), dtype)
    return st


def _assert_same_histories(tout, jout, n_hist):
    """The padded histories and the final chi2 of a run function, the last
    ``n_hist`` entries of its tuple."""
    for got, want in zip(tout[-n_hist - 1:-1], jout[-n_hist - 1:-1]):
        got, want = got.cpu().numpy(), np.asarray(want)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(tout[-1], float(jout[-1]), rtol=RTOL)


def test_make_lm_run_matches_jax(graph):
    """``make_lm_run``: the JAX package's tuple (estimates, λ, ν,
    iterations, the three histories padded to ``max_iters``, final chi2)
    from one call, with the λ₀ = τ·max|H_jj| sentinel."""
    jp, tp = _pair(graph)
    js, ts = JPCG(**_fast()).setup(jp), TPCG(**_fast()).setup(tp)
    jout = j_make_lm_run(jp, js, max_iters=12)(
        jp.data, dict(jp.estimates), jnp.asarray(-1e-5, jp.dtype),
        jnp.asarray(2.0, jp.dtype), jnp.asarray(8, jnp.int32), js.aux,
        _runner_state(js, jp.dtype))
    tout = t_make_lm_run(tp, ts, max_iters=12)(
        tp.data, tp.estimates, -1e-5, 2.0, 8, getattr(ts, "aux", ()),
        getattr(ts, "state0", None))
    assert tout[3] == int(jout[3]) == 8
    np.testing.assert_allclose(tout[1], float(jout[1]), rtol=RTOL)
    assert tout[2] == float(jout[2])
    _assert_same_histories(tout, jout, 3)
    for t in jout[0]:
        np.testing.assert_allclose(tout[0][t].numpy(), np.asarray(jout[0][t]),
                                   rtol=RTOL, atol=1e-9)


def test_make_gn_run_matches_jax(graph):
    """``make_gn_run``: the JAX package's tuple (estimates, iterations, the
    chi2 and CG histories padded to ``max_iters``, final chi2), bench.py's
    polish solver after 5 LM iterations."""
    jp, tp = _pair(graph)
    j_optimize_fused(jp, JPCG(**_fast()), 5)
    tg2o.optimize_fused(tp, TPCG(**_fast()), 5)
    kw = dict(max_iter=128, tol=1e-6, precond="chunk2", chunk_size=16,
              carry_factor=0.01, matvec_precision="highest")
    js, ts = JPCG(**kw).setup(jp), TPCG(**kw).setup(tp)
    jout = j_make_gn_run(jp, js, max_iters=10)(
        jp.data, dict(jp.estimates), jnp.asarray(4, jnp.int32), js.aux,
        _runner_state(js, jp.dtype))
    tout = t_make_gn_run(tp, ts, max_iters=10)(
        tp.data, tp.estimates, 4, getattr(ts, "aux", ()),
        getattr(ts, "state0", None))
    assert tout[1] == int(jout[1]) == 4
    _assert_same_histories(tout, jout, 2)
    for t in jout[0]:
        np.testing.assert_allclose(tout[0][t].numpy(), np.asarray(jout[0][t]),
                                   rtol=RTOL, atol=1e-9)


def test_gauss_newton_optimizer_matches_jax(graph):
    jp, tp = _pair(graph)
    jo = JSparseOptimizer(jp, algorithm=JGaussNewton(), solver=JHostChol())
    to = tg2o.SparseOptimizer(tp, algorithm=tg2o.GaussNewton(),
                              solver=tg2o.HostCholSolver())
    assert to.optimize(5) == jo.optimize(5) == 5
    np.testing.assert_allclose([s.chi2 for s in to.batch_statistics],
                               [s.chi2 for s in jo.batch_statistics],
                               rtol=RTOL)
    np.testing.assert_allclose(to.chi2(), jo.chi2(), rtol=RTOL)


# --------------------------------------------------------------------------- #
# HostCholSolver
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("lam", [0.0, 1e-2])
def test_host_chol_step_matches_jax(graph, lam):
    jp, tp = _pair(graph)
    jl = jp.linearize_jit(jp.data, jp.estimates)
    tl = tp.linearize_fn(tp.data, tp.estimates)
    jdx = np.asarray(JHostChol().setup(jp).solve(jp.data, jl, lam))
    tdx = tg2o.HostCholSolver().setup(tp).solve(tp.data, tl, lam)
    assert tdx.dtype == torch.float64 and tdx.device.type == "cpu"
    np.testing.assert_allclose(tdx.numpy(), jdx, rtol=1e-10,
                               atol=1e-10 * np.abs(jdx).max())
    # the step solves the damped system: the dense solver's dx
    ddx = tg2o.DenseSolver().setup(tp).solve(tp.data, tl, lam).numpy()
    np.testing.assert_allclose(tdx.numpy(), ddx, rtol=1e-8,
                               atol=1e-8 * np.abs(ddx).max())


def test_optimize_gn_host_matches_jax(graph):
    jp, tp = _pair(graph)
    jres = j_gn_host(jp, JHostChol(), 6)
    tres = tg2o.optimize_gn_host(tp, tg2o.HostCholSolver(), 6)
    assert tres["iterations"] == jres["iterations"] == 6
    np.testing.assert_allclose(tres["chi2_per_iteration"],
                               jres["chi2_per_iteration"], rtol=RTOL)
    np.testing.assert_allclose(tres["chi2_final"], jres["chi2_final"],
                               rtol=RTOL)
    assert len(tres["host_walls"]) == 6


def _two_pose_graph(G, types, info):
    g = G()
    g.add_vertex(0, types.VertexSE2, np.zeros(3), fixed=True)
    g.add_vertex(1, types.VertexSE2, np.array([1.0, 0, 0]))
    g.add_edge(types.EdgeSE2, [0, 1], np.array([1.0, 0, 0]), info)
    return g


def test_host_chol_non_pd_gives_nan_step():
    """Negative information makes H negative definite on vertex 1: the
    step is NaN, as in the JAX package (``tests/test_host_chol.py``)."""
    p = _two_pose_graph(tg2o.Graph, tslam2d, -np.eye(3)).compile(
        dtype=torch.float64, device="cpu")
    lin = p.linearize_fn(p.data, p.estimates)
    dx = tg2o.HostCholSolver().setup(p).solve(p.data, lin, 0.0)
    assert torch.isnan(dx).any()
    res = tg2o.optimize_gn_host(p, tg2o.HostCholSolver(), 3)
    assert res["iterations"] == 1


def _calib_graph(G, types):
    """EDGE_SE2_XY_CALIB edges, some with the pose slot and the calibration
    slot bound to the SAME vertex."""
    rng = np.random.default_rng(5)
    g = G()
    for i in range(6):
        g.add_vertex(i, types.VertexSE2,
                     [i + rng.normal(scale=0.1), rng.normal(scale=0.1),
                      rng.normal(scale=0.2)], fixed=(i == 0))
    for j in range(4):
        g.add_vertex(10 + j, types.VertexPointXY, rng.normal(size=2) * 2)
    g.add_vertex(20, types.VertexSE2, [0.1, 0.0, 0.05])
    for i in range(5):
        g.add_edge(types.EdgeSE2, [i, i + 1], [1.0, 0.0, 0.0],
                   np.eye(3) * 30)
    for i in range(6):
        for j in range(4):
            calib = i if (i + j) % 3 == 0 else 20
            g.add_edge(types.EdgeSE2PointXYCalib, [i, 10 + j, calib],
                       rng.normal(size=2), np.eye(2) * 10)
    return g


def test_host_chol_same_vertex_hyper_edge():
    """A same-vertex slot pair adds ``H_ab + H_abᵀ`` into that vertex's
    diagonal block: the step equals the dense solver's and the JAX
    package's."""
    jp = _calib_graph(JGraph, jslam2d).compile()
    tp = _calib_graph(tg2o.Graph, tslam2d).compile(dtype=torch.float64,
                                                   device="cpu")
    hs = tg2o.HostCholSolver().setup(tp)
    assert hs._self_maps                      # the path is taken
    tl = tp.linearize_fn(tp.data, tp.estimates)
    tdx = hs.solve(tp.data, tl, 1e-3).numpy()
    ddx = tg2o.DenseSolver().setup(tp).solve(tp.data, tl, 1e-3).numpy()
    np.testing.assert_allclose(tdx, ddx, rtol=1e-9,
                               atol=1e-9 * np.abs(ddx).max())
    jl = jp.linearize_jit(jp.data, jp.estimates)
    jdx = np.asarray(JHostChol().setup(jp).solve(jp.data, jl, 1e-3))
    np.testing.assert_allclose(tdx, jdx, rtol=1e-10,
                               atol=1e-10 * np.abs(jdx).max())


def test_hostchol_source_is_the_jax_packages_copy():
    with open(os.path.join(ROOT, "g2o_tpu", "native", "hostchol.cpp"),
              "rb") as fh:
        jax_src = fh.read()
    with open(os.path.join(ROOT, "g2o_tpu_torch", "native", "hostchol.cpp"),
              "rb") as fh:
        assert fh.read() == jax_src


def test_host_cholesky_raises_without_its_library(monkeypatch):
    from g2o_tpu_torch import native

    monkeypatch.setattr(native, "get_hostchol_lib", lambda: None)
    with pytest.raises(RuntimeError):
        native.HostCholesky(1, np.array([0, 1]), np.array([0]))


def test_gn_entry_points_raise_without_a_card():
    """No CPU run unless asked: the default device is the card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from g2o_tpu_torch.sim.generators import create_manhattan as t_cm

    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_cm(n_poses=20, seed=0).compile()
