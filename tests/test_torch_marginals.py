"""Port parity: ``compute_marginals`` and ``compute_cross_marginals`` on all
four routes against the JAX package's.

Each scene is compiled by the JAX package and carried into the port by
``port_problem``.  Float64 on the CPU, every block to 1e-9 (max |Δ| / max
|ref| over the requested blocks):

* a sphere: ``dense``, ``sparse`` (a few vertices: the supernodal factor
  and one sweep pair over their unit blocks), ``takahashi`` (every block:
  one factorization and the reverse Takahashi sweep), and ``auto``; the
  routes also agree with each other; the cross block on the dense and the
  sparse route;
* a bundle adjustment scene: ``schur`` (pose and landmark blocks from the
  reduced camera system) against the JAX package's and the port's
  ``dense`` route, ``auto`` taking ``schur``; ``takahashi`` over the mixed
  camera and point types (padded blocks);
* fixed vertices get zero blocks, as in the JAX package."""

import numpy as np
import pytest

import g2o_tpu.types  # noqa: F401
from g2o_tpu.core import marginals as jm
from g2o_tpu.sim.generators import create_ba_scene, create_sphere
from g2o_tpu_torch.core import marginals as tm
from test_torch_problem import port_problem

TOL = 1e-9
LAM = 1e-5


@pytest.fixture(scope="module")
def sphere():
    g = create_sphere(nodes_per_level=10, laps=4, seed=7)
    g.set_robust_kernel("Huber", 1.0)
    jp = g.compile()
    return jp, port_problem(jp)


@pytest.fixture(scope="module")
def ba():
    jp = create_ba_scene(n_cameras=6, n_points=40, seed=9)[0].compile()
    return jp, port_problem(jp)


def _close(got, want, vids):
    scale = max(np.abs(want[v]).max() for v in vids)
    for v in vids:
        assert got[v].shape == want[v].shape
        assert np.abs(got[v] - want[v]).max() <= TOL * scale, v


# route -> the sphere vertices it is asked for (the sparse route covers a
# few; with most of the graph it hands over to takahashi)
SPHERE_ROUTES = {"dense": [0, 3, 17, 38], "sparse": [0, 3, 17, 38],
                 "takahashi": None, "auto": [5, 6]}


@pytest.mark.parametrize("method", list(SPHERE_ROUTES))
def test_sphere_routes_match_jax(sphere, method):
    jp, tp = sphere
    vids = SPHERE_ROUTES[method] or sorted(jp.vid_index)
    want = jm.compute_marginals(jp, vids, lam=LAM, method=method)
    got = tm.compute_marginals(tp, vids, lam=LAM, method=method)
    _close(got, want, vids)
    # the fixed vertex 0 is pinned: a zero block
    if 0 in vids:
        assert not got[0].any()
    dense = tm.compute_marginals(tp, vids, lam=LAM, method="dense")
    _close(got, dense, vids)


@pytest.mark.parametrize("method", ["dense", "sparse"])
def test_cross_marginals_match_jax(sphere, method):
    jp, tp = sphere
    want = jm.compute_cross_marginals(jp, 7, 21, lam=LAM, method=method)
    got = tm.compute_cross_marginals(tp, 7, 21, lam=LAM, method=method)
    assert got.shape == want.shape == (6, 6)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("method", ["schur", "auto", "takahashi"])
def test_ba_routes_match_jax(ba, method):
    jp, tp = ba
    cams = [v for v, (t, _) in jp.vid_index.items()
            if t == "VERTEX_SE3:EXPMAP"]
    pts = [v for v, (t, _) in jp.vid_index.items()
           if t == "VERTEX_TRACKXYZ"]
    vids = sorted(cams)[:4] + sorted(pts)[::10]
    want = jm.compute_marginals(jp, vids, lam=1e-3, method=method)
    got = tm.compute_marginals(tp, vids, lam=1e-3, method=method)
    _close(got, want, vids)
    dense = tm.compute_marginals(tp, vids, lam=1e-3, method="dense")
    _close(got, dense, vids)
    assert {got[v].shape for v in pts if v in got} == {(3, 3)}


def test_sparse_route_refuses_nary_edges():
    from g2o_tpu.core.graph import Graph as JGraph
    from g2o_tpu.types import slam2d as jslam2d
    from test_torch_gn import _calib_graph

    tp = port_problem(_calib_graph(JGraph, jslam2d).compile())
    with pytest.raises(NotImplementedError):
        tm.compute_marginals(tp, [1], method="sparse")
    with pytest.raises(NotImplementedError):
        tm.compute_cross_marginals(tp, 1, 2, method="sparse")
