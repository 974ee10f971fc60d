"""Port parity: the algorithm-level public names of ``g2o_tpu`` —
``Dogleg``, ``FusedLevenbergMarquardt``, ``optimize_fused``'s
``gain_threshold`` / ``history_cap``, ``SparseOptimizer``'s stop controls,
the ``Problem`` and ``Graph`` methods, and the solver knobs the port
accepts and ignores.

A small sphere is compiled by the JAX package and carried into the port by
``port_problem``, so both packages work on the same numbers (float64, CPU):

* Dogleg's per-iteration chi2 and trust radius to rtol 1e-9 and its step
  kinds (GN / SD / blend) equal, over the dense and the supernodal solver
  of the port against the JAX package's Dogleg over its dense solver (the
  two direct solvers agree to ~1e-13 here), from a large radius (GN steps)
  and a small one (steepest-descent and blended steps);
* ``FusedLevenbergMarquardt`` against the JAX one (rtol 1e-9, direct
  solver) and against the port's host ``LevenbergMarquardt`` (rtol 1e-6);
* ``gain_threshold`` stops both packages at the same iteration; the
  ``history_cap`` clamp;
* ``get_estimate``, ``edge_chi2_fn``, ``hvp_fn`` and ``gauge_freedom``
  to rtol 1e-9; the ``Graph`` checks and edits give the JAX package's
  answers;
* ``g2o_tpu_torch.__all__`` holds every name of ``g2o_tpu.__all__``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import g2o_tpu
import g2o_tpu.types  # noqa: F401
import g2o_tpu_torch as tg
from g2o_tpu.core.graph import Graph as JGraph
from g2o_tpu.core.lm_fused import optimize_fused as j_optimize_fused
from g2o_tpu.core.solvers import DenseSolver as JDense
from g2o_tpu.core.solvers import PCGSolver as JPCG
from g2o_tpu.core.solvers.schur_implicit import ImplicitSchurSolver as JISS
from g2o_tpu.sim.generators import create_ba_scene, create_sphere
from test_torch_problem import port_problem

RTOL = 1e-9
# initial trust radius -> iterations: GN steps from a large radius; from a
# small one steepest-descent steps, then blended, then GN
DOGLEG_ITERS = {100.0: 6, 1e-3: 12}


@pytest.fixture(scope="module")
def sphere():
    g = create_sphere(nodes_per_level=10, laps=4, seed=7)
    g.set_robust_kernel("Huber", 1.0)
    return g


def _dogleg_history(opt, iters):
    rec = []
    opt.post_iteration_actions.append(lambda o, it: rec.append(
        (o.current_chi2, o.algorithm.delta, o.algorithm._last_step)))
    n = opt.optimize(iters)
    return n, rec


@pytest.fixture(scope="module")
def jax_dogleg(sphere):
    """The JAX package's Dogleg histories over its dense solver, by
    initial radius."""
    out = {}
    for delta, iters in DOGLEG_ITERS.items():
        jp = sphere.compile()
        out[delta] = _dogleg_history(g2o_tpu.SparseOptimizer(
            jp, algorithm=g2o_tpu.Dogleg(initial_delta=delta),
            solver=JDense()), iters)
    return out


def test_exports_cover_the_jax_package():
    assert set(g2o_tpu.__all__) <= set(tg.__all__)
    for name in tg.__all__:
        assert getattr(tg, name) is not None


@pytest.mark.parametrize("solver", ["dense", "supernodal"])
@pytest.mark.parametrize("delta", list(DOGLEG_ITERS))
def test_dogleg_trajectory_matches_jax(sphere, jax_dogleg, solver, delta):
    tp = port_problem(sphere.compile())
    ts = (tg.DenseSolver() if solver == "dense"
          else tg.SupernodalCholeskySolver())
    n, rec = _dogleg_history(tg.SparseOptimizer(
        tp, algorithm=tg.Dogleg(initial_delta=delta), solver=ts),
        DOGLEG_ITERS[delta])
    jn, jrec = jax_dogleg[delta]
    assert n == jn == DOGLEG_ITERS[delta]
    assert [r[2] for r in rec] == [r[2] for r in jrec]
    kinds = {r[2] for r in rec}
    assert kinds == ({"GN"} if delta == 100.0 else {"SD", "DL", "GN"})
    np.testing.assert_allclose([r[:2] for r in rec], [r[:2] for r in jrec],
                               rtol=RTOL)


def test_fused_lm_matches_jax_and_host_lm(sphere):
    jp = sphere.compile()
    jo = g2o_tpu.SparseOptimizer(
        jp, algorithm=g2o_tpu.FusedLevenbergMarquardt(), solver=JDense())
    jo.optimize(6)
    to = tg.SparseOptimizer(port_problem(sphere.compile()),
                            algorithm=tg.FusedLevenbergMarquardt(),
                            solver=tg.DenseSolver())
    to.optimize(6)
    np.testing.assert_allclose([s.chi2 for s in to.batch_statistics],
                               [s.chi2 for s in jo.batch_statistics],
                               rtol=RTOL)
    assert [s.levenberg_iterations for s in to.batch_statistics] == \
        [s.levenberg_iterations for s in jo.batch_statistics]
    assert to.current_chi2 == pytest.approx(jo.current_chi2, rel=RTOL)
    assert to.algorithm._lambda == pytest.approx(jo.algorithm._lambda,
                                                 rel=RTOL)
    host = tg.SparseOptimizer(port_problem(sphere.compile()),
                              algorithm=tg.LevenbergMarquardt(),
                              solver=tg.DenseSolver())
    host.optimize(6)
    assert host.current_chi2 == pytest.approx(to.current_chi2, rel=1e-6)
    assert host.algorithm._lambda == pytest.approx(to.algorithm._lambda,
                                                   rel=1e-6)


def test_gain_threshold_and_history_cap(sphere):
    jres = j_optimize_fused(sphere.compile(), JDense(), 50,
                            gain_threshold=1e-6)
    tres = tg.optimize_fused(port_problem(sphere.compile()), tg.DenseSolver(),
                             50, gain_threshold=1e-6)
    assert tres["iterations"] == jres["iterations"] < 50
    np.testing.assert_allclose(tres["chi2_per_iteration"],
                               jres["chi2_per_iteration"], rtol=RTOL)
    for fn in (tg.optimize_fused, tg.optimize_fused_gn):
        res = fn(port_problem(sphere.compile()), tg.DenseSolver(), 10,
                 history_cap=3)
        assert res["iterations"] == 3


@pytest.mark.parametrize("control", ["force_stop", "gain"])
def test_sparse_optimizer_stop_controls_match_jax(sphere, control):
    out = []
    for pkg, p, solver in ((g2o_tpu, sphere.compile(), JDense()),
                           (tg, port_problem(sphere.compile()),
                            tg.DenseSolver())):
        opt = pkg.SparseOptimizer(p, algorithm=pkg.LevenbergMarquardt(),
                                  solver=solver)
        if control == "force_stop":
            def stop(o, it):
                if it == 2:
                    o.force_stop = True
            opt.post_iteration_actions.append(stop)
        else:
            opt.terminate_gain_threshold = 1e-3
        out.append((opt.optimize(20), opt.current_chi2))
    (jn, jchi), (tn, tchi) = out
    assert tn == jn < 20
    assert tchi == pytest.approx(jchi, rel=RTOL)


def test_problem_methods_match_jax(sphere):
    jp = sphere.compile()
    tp = port_problem(jp)
    for vid in (0, 7, 39):
        np.testing.assert_array_equal(tp.get_estimate(vid),
                                      jp.get_estimate(vid))
    assert tp.gauge_freedom() == jp.gauge_freedom() is False
    je = jp.edge_chi2_fn(jp.data, jp.estimates)
    te = tp.edge_chi2_fn(tp.data, tp.estimates)
    for name in je:
        np.testing.assert_allclose(te[name].numpy(), je[name], rtol=RTOL)
    total = sum(float(v.sum()) for v in te.values())
    assert total == pytest.approx(float(tp.chi2_fn(tp.data,
                                                   tp.estimates)[0]),
                                  rel=1e-12)
    jl = jp.linearize_jit(jp.data, jp.estimates)
    tl = tp.linearize_fn(tp.data, tp.estimates)
    v = np.random.default_rng(3).standard_normal(jp.total_dim)
    jhv = np.asarray(jp.hvp_jit(jp.data, jl, jnp.asarray(v)))
    thv = tp.hvp_fn(tp.data, tl, torch.as_tensor(v))
    np.testing.assert_allclose(thv.numpy(), jhv, rtol=RTOL,
                               atol=RTOL * np.abs(jhv).max())


def _graph_edits(G):
    """The same edits and checks on a ``Graph`` of either package: a
    four-pose chain, then a non-symmetric, an indefinite and a non-finite
    record.  Returns what each call gave."""
    g = G()
    pose = np.array([0.0, 0, 0, 0, 0, 0, 1])
    for i in range(4):
        g.add_vertex(i, "VERTEX_SE3:QUAT", pose + [i, 0, 0, 0, 0, 0, 0],
                     fixed=i == 0)
    for i in range(3):
        g.add_edge("EDGE_SE3:QUAT", [i, i + 1], [1.0, 0, 0, 0, 0, 0, 1],
                   np.eye(6))
    out = [g.has_vertex(2), g.has_vertex(9), g.verify_information_matrices(),
           g.check_finite()]
    g.set_estimate(1, pose + [0.5, 0.1, 0, 0, 0, 0, 0])
    out.append(g.vertex(1).estimate.tolist())
    bad = np.eye(6)
    bad[0, 1] = 0.5
    g.add_edge("EDGE_SE3:QUAT", [0, 2], [2.0, 0, 0, 0, 0, 0, 1], bad)
    out.append(g.verify_information_matrices())
    g.edges()[-1].information = -np.eye(6)
    out.append(g.verify_information_matrices())
    out.append(g.remove_vertex(2))
    out += [g.remove_vertex(2), g.num_vertices, g.num_edges,
            g.verify_information_matrices()]
    g.set_estimate(3, np.full(7, np.nan))
    out.append(g.check_finite())
    return out


def test_graph_methods_match_jax():
    jout, tout = _graph_edits(JGraph), _graph_edits(tg.Graph)
    assert tout == jout
    assert jout[:4] == [True, False, True, True]
    assert jout[5:] == [False, False, True, False, 3, 1, True, False]


def test_pcg_knobs_accepted_as_in_jax(sphere):
    """``abs_tol``, ``onehot_max_segments`` and ``precond_dtype`` (the
    problem's own dtype) are accepted; one converged step equals the JAX
    package's with the same knobs, and the dense solver's."""
    kw = dict(max_iter=500, tol=1e-12, abs_tol=1e-3, onehot_max_segments=64,
              precond_dtype="float64")
    jp = sphere.compile()
    tp = port_problem(jp)
    jl = jp.linearize_jit(jp.data, jp.estimates)
    tl = tp.linearize_fn(tp.data, tp.estimates)
    dj = np.asarray(JPCG(**kw).setup(jp).solve(jp.data, jl, 1.0))
    ts = tg.PCGSolver(**kw)
    assert (ts.abs_tol, ts.onehot_max_segments) == (1e-3, 64)
    dt = ts.setup(tp).solve(tp.data, tl, 1.0).numpy()
    dd = tg.DenseSolver().setup(tp).solve(tp.data, tl, 1.0).numpy()
    for ref in (dj, dd):
        np.testing.assert_allclose(dt, ref, rtol=1e-8,
                                   atol=1e-8 * np.abs(ref).max())


def test_implicit_schur_onehot_knob_accepted_as_in_jax():
    g, _ = create_ba_scene(n_cameras=6, n_points=40, seed=9)
    jp = g.compile()
    tp = port_problem(jp)
    jl = jp.linearize_jit(jp.data, jp.estimates)
    tl = tp.linearize_fn(tp.data, tp.estimates)
    kw = dict(max_iter=500, tol=1e-12, onehot_max_segments=4)
    dj = np.asarray(JISS(**kw).setup(jp).solve(jp.data, jl, 1e-2))
    ts = tg.ImplicitSchurSolver(**kw)
    assert ts.onehot_max_segments == 4
    dt = ts.setup(tp).solve(tp.data, tl, 1e-2).numpy()
    np.testing.assert_allclose(dt, dj, rtol=1e-8,
                               atol=1e-8 * np.abs(dj).max())


def test_schur_solver_points_at_the_general_path():
    g, truth = create_ba_scene(n_cameras=4, n_points=20, seed=1)
    g.set_marginalized(next(iter(truth)), False)
    tp = port_problem(g.compile())
    with pytest.raises(NotImplementedError, match="ImplicitSchurSolver"):
        tg.SchurSolver().setup(tp)
