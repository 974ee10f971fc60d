"""Port parity of ``core/initial_guess.py`` (spanning-tree propagation,
``hyper_dijkstra``) and ``core/slam2d_linear.py`` (the linear 2D
initialization) against the JAX package, float64 on the CPU.

The graphs come from both packages' ``create_manhattan``, which give the
same bits, or from one ``.g2o`` text read by both.  The initial guess is
plain numpy in both packages and is held bit for bit; the linear
initialization solves its two least-squares problems with PCG to 1e-10 in
each package (different summation orders), so its poses agree to 1e-8."""

import numpy as np
import pytest

import g2o_tpu.types  # noqa: F401
import g2o_tpu_torch as tg2o
from g2o_tpu.core.graph import Graph as JGraph
from g2o_tpu.core.initial_guess import compute_initial_guess as j_guess
from g2o_tpu.core.initial_guess import hyper_dijkstra as j_dijkstra
from g2o_tpu.core.slam2d_linear import solve_slam2d_linear as j_linear
from g2o_tpu.io import g2o_format as jio
from g2o_tpu.sim.generators import create_manhattan as j_manhattan
from g2o_tpu.types import slam2d as jslam2d
from g2o_tpu_torch.core.graph import Graph as TGraph
from g2o_tpu_torch.core.initial_guess import (compute_initial_guess,
                                              hyper_dijkstra)
from g2o_tpu_torch.core.slam2d_linear import solve_slam2d_linear
from g2o_tpu_torch.io import g2o_format as tio
from g2o_tpu_torch.sim.generators import create_manhattan, create_sphere
from g2o_tpu_torch.types import slam2d as tslam2d


def _estimates(g):
    return {vid: r.estimate.copy() for vid, r in g.vertices().items()}


def _scramble(g, value):
    for rec in g.vertices().values():
        if not rec.fixed:
            rec.estimate = np.asarray(value, dtype=np.float64)


def test_initial_guess_se2_matches_jax():
    jg, tg = j_manhattan(n_poses=60, seed=5), create_manhattan(n_poses=60,
                                                               seed=5)
    _scramble(jg, np.zeros(3))
    _scramble(tg, np.zeros(3))
    n = compute_initial_guess(tg)
    assert n == j_guess(jg) == 59
    je, te = _estimates(jg), _estimates(tg)
    for vid in je:
        np.testing.assert_array_equal(te[vid], je[vid])
    # the odometry-propagated guess is a sane starting point
    p = tg.compile(device="cpu")
    opt = tg2o.SparseOptimizer(p, solver=tg2o.DenseSolver())
    chi0 = opt.chi2()
    opt.optimize(10)
    assert opt.chi2() < chi0


@pytest.mark.parametrize("cost", [None, "norm"])
def test_initial_guess_se3_matches_jax(cost):
    text = tio.dumps(create_sphere(nodes_per_level=8, laps=3, radius=10.0,
                                   seed=6))
    jg, tg = jio.loads(text), tio.loads(text)
    jg.set_fixed(0, True)
    tg.set_fixed(0, True)
    _scramble(jg, [0, 0, 0, 0, 0, 0, 1.0])
    _scramble(tg, [0, 0, 0, 0, 0, 0, 1.0])
    fn = (None if cost is None else
          lambda e, frm, to: 1.0 + float(np.linalg.norm(e.measurement[:3])))
    n = compute_initial_guess(tg, cost=fn)
    assert n == j_guess(jg, cost=fn) == 23
    je, te = _estimates(jg), _estimates(tg)
    for vid in je:
        np.testing.assert_array_equal(te[vid], je[vid])


def _chain(G, se2):
    g = G()
    for i in range(4):
        g.add_vertex(i, se2.VertexSE2, [float(i), 0, 0], fixed=(i == 0))
    info = np.eye(3)
    # chain 0-1-2-3 plus a shortcut 0-3
    for i in range(3):
        g.add_edge(se2.EdgeSE2, [i, i + 1], [1.0, 0, 0], info)
    g.add_edge(se2.EdgeSE2, [0, 3], [3.0, 0, 0], info)
    return g


def _norm2(e, frm, to):
    return float(np.linalg.norm(e.measurement[:2]) ** 2)


@pytest.mark.parametrize("case", [
    dict(),                                           # uniform: shortcut
    dict(cost=_norm2),                                # the chain wins
    dict(cost=lambda e, f, t: float("inf")),          # every edge forbidden
    dict(cost=lambda e, f, t: 1.0 if abs(f - t) == 1 else float("inf"),
         max_distance=2.0)])
def test_hyper_dijkstra_matches_jax(case):
    """Pluggable-cost traversal (reference hyper_dijkstra.h:77-88)."""
    jd, jpar = j_dijkstra(_chain(JGraph, jslam2d), [0], **case)
    td, tpar = hyper_dijkstra(_chain(TGraph, tslam2d), [0], **case)
    assert td == jd
    assert {v: (None if p is None else (p[0].vids, p[1]))
            for v, p in tpar.items()} == \
        {v: (None if p is None else (p[0].vids, p[1]))
         for v, p in jpar.items()}


def test_hyper_dijkstra_costs():
    g = _chain(TGraph, tslam2d)
    dist, parent = hyper_dijkstra(g, [0])
    assert dist[3] == 1.0          # uniform cost takes the shortcut
    assert parent[0] is None and parent[3][1] == 0
    dist2, parent2 = hyper_dijkstra(g, [0], cost=_norm2)
    assert dist2[3] == 3.0 and parent2[3][1] == 2
    dist3, _ = hyper_dijkstra(g, [0], cost=lambda e, f, t: float("inf"))
    assert set(dist3) == {0}
    dist4, _ = hyper_dijkstra(
        g, [0], cost=lambda e, f, t: 1.0
        if abs(f - t) == 1 else float("inf"), max_distance=2.0)
    assert set(dist4) == {0, 1, 2}


def test_guess_dijkstra_relaxation():
    """A vertex discovered first through an expensive loop closure is
    re-parented (and initialised) through the cheaper odometry chain."""
    g = TGraph()
    for i in range(4):
        g.add_vertex(i, tslam2d.VertexSE2, np.zeros(3), fixed=(i == 0))
    for i in range(3):
        g.add_edge(tslam2d.EdgeSE2, [i, i + 1], [1.0, 0.0, 0.0], np.eye(3))
    g.add_edge(tslam2d.EdgeSE2, [0, 3], [99.0, 0.0, 0.0], np.eye(3))

    def cost(e, frm, to):
        # loop closures expensive, odometry cheap
        return 10.0 if abs(e.vids[0] - e.vids[1]) > 1 else 1.0

    assert compute_initial_guess(g, cost=cost) == 3
    assert abs(g.vertex(3).estimate[0] - 3.0) < 1e-9


def test_guess_unary_prior_and_pose_root_fallback():
    # (a) a unary prior pins its vertex and seeds propagation (no fixed)
    g = TGraph()
    g.add_vertex(0, tslam2d.VertexSE2, np.zeros(3))
    g.add_vertex(1, tslam2d.VertexSE2, np.zeros(3))
    g.add_edge(tslam2d.EdgeSE2Prior, [0], [5.0, 1.0, 0.2], np.eye(3))
    g.add_edge(tslam2d.EdgeSE2, [0, 1], [1.0, 0.0, 0.0], np.eye(3))
    assert compute_initial_guess(g) == 2
    assert abs(g.vertex(0).estimate[0] - 5.0) < 1e-9
    assert g.vertex(1).estimate[0] > 5.5

    # (b) a landmark holds the lowest id, nothing fixed: the fallback root
    # is the pose (largest tangent dim), not the landmark
    g2 = TGraph()
    g2.add_vertex(0, tslam2d.VertexPointXY, [0.0, 0.0])
    g2.add_vertex(1, tslam2d.VertexSE2, [2.0, 0.0, 0.0])
    g2.add_vertex(2, tslam2d.VertexSE2, np.zeros(3))
    g2.add_edge(tslam2d.EdgeSE2PointXY, [1, 0], [1.0, 1.0], np.eye(2))
    g2.add_edge(tslam2d.EdgeSE2, [1, 2], [1.0, 0.0, 0.0], np.eye(3))
    assert compute_initial_guess(g2) == 2
    assert abs(g2.vertex(0).estimate[0] - 3.0) < 1e-9  # se2_act from pose 1
    assert abs(g2.vertex(2).estimate[0] - 3.0) < 1e-9


def test_slam2d_linear_matches_jax():
    jg, tg = j_manhattan(n_poses=200, seed=12), create_manhattan(
        n_poses=200, seed=12)
    _scramble(jg, np.zeros(3))
    _scramble(tg, np.zeros(3))
    p0 = tg.compile(device="cpu")
    chi_zeros = float(p0.chi2_fn(p0.data, p0.estimates)[0])
    n = solve_slam2d_linear(tg, device="cpu")
    assert n == j_linear(jg) == 200
    je, te = _estimates(jg), _estimates(tg)
    for vid in je:
        np.testing.assert_allclose(te[vid], je[vid], rtol=1e-8, atol=1e-8)
    p1 = tg.compile(device="cpu")
    chi_lin = float(p1.chi2_fn(p1.data, p1.estimates)[0])
    # the linear init lands near the optimum (Carlone et al. property)
    assert chi_lin < 1e-2 * chi_zeros


def test_slam2d_linear_no_se2_edges():
    g = TGraph()
    g.add_vertex(0, tslam2d.VertexSE2, np.zeros(3), fixed=True)
    assert solve_slam2d_linear(g, device="cpu") == 0
