"""Port parity: the numeric ``SparseCholeskySolver`` (level-scheduled block
Cholesky) against the JAX package's.

Each scene is compiled by the JAX package and carried into the port by
``port_problem``.  Float64 on the CPU:

* the padded level schedule (``build_schedule``) and the Takahashi pair
  schedule equal the JAX package's, array for array;
* one solve at λ = 1e-3 matches the JAX solver's and the port's
  ``DenseSolver`` to 1e-9 (max |Δ| / max |ref|) on a sphere, a 300-pose
  manhattan, a mixed-type bundle adjustment scene (cameras of 6 and points
  of 3 dims, padded to 6) and a graph of ternary calibration edges, some of
  which bind one vertex in two slots (``H_ab + H_abᵀ`` goes to its
  diagonal block, the ``be09252`` regression);
* 10 fused LM iterations match the JAX run (chi2 to rtol 1e-9, the same
  trials);
* a Hessian that is not positive definite gives a NaN step, as the JAX
  package's Cholesky does, instead of an exception."""

import numpy as np
import pytest
import torch

import g2o_tpu.types  # noqa: F401
import g2o_tpu_torch as tg
from g2o_tpu.core.graph import Graph as JGraph
from g2o_tpu.core.lm_fused import optimize_fused as j_optimize_fused
from g2o_tpu.core.solvers import sparse_chol as jsc
from g2o_tpu.sim.generators import (create_ba_scene, create_manhattan,
                                    create_sphere)
from g2o_tpu.types import slam2d as jslam2d
from g2o_tpu_torch.core.solvers import sparse_chol as tsc
from g2o_tpu_torch.types import slam2d as tslam2d
from test_torch_gn import _calib_graph, _two_pose_graph
from test_torch_problem import port_problem

LAM = 1e-3
SCENES = {
    "sphere": lambda: create_sphere(nodes_per_level=10, laps=4, seed=7),
    "manhattan": lambda: create_manhattan(n_poses=300, seed=0),
    "ba_mixed_type": lambda: create_ba_scene(n_cameras=6, n_points=40,
                                             seed=9)[0],
    "calib_same_vertex": lambda: _calib_graph(JGraph, jslam2d),
}


def _close(a, b, tol=1e-9):
    a, b = np.asarray(a), np.asarray(b)
    assert np.abs(a - b).max() <= tol * np.abs(b).max()


def test_schedules_equal_jax():
    jp = SCENES["sphere"]().compile()
    tp = port_problem(jp)
    js = jsc.SparseCholeskySolver().setup(jp)
    ts = tg.SparseCholeskySolver().setup(tp)
    jsched = jsc.build_schedule(js._sym, 6)
    for k in ("lvl_cols", "solves", "updates", "row_of_slot"):
        np.testing.assert_array_equal(ts._sched[k], jsched[k])
    np.testing.assert_array_equal(tsc.build_takahashi_schedule(ts._sym),
                                  jsc.build_takahashi_schedule(js._sym))
    # the trimmed levels hold exactly the unpadded entries
    levels = ts.aux["levels"]
    assert len(levels) == jsched["L"]
    assert sum(int(lv["cols"].numel()) for lv in levels) == jsched["n"]
    assert sum(int(lv["s_slot"].numel()) for lv in levels) == jsched["nnz"]
    assert sum(int(lv["u_dst"].numel()) for lv in levels) == int(
        (jsched["updates"][..., 0] >= 0).sum())


@pytest.mark.parametrize("scene", list(SCENES))
def test_solve_matches_jax_and_dense(scene):
    jp = SCENES[scene]().compile()
    tp = port_problem(jp)
    jl = jp.linearize_jit(jp.data, jp.estimates)
    tl = tp.linearize_fn(tp.data, tp.estimates)
    ts = tg.SparseCholeskySolver().setup(tp)
    if scene == "calib_same_vertex":
        assert ts.aux["self_maps"]           # the same-vertex path is taken
    if scene == "ba_mixed_type":
        assert ts._block_dim == 6 and len(tp.vertex_types) == 2
    dt = ts.solve(tp.data, tl, LAM)
    assert dt.dtype == torch.float64 and dt.shape == (tp.total_dim,)
    dj = np.asarray(jsc.SparseCholeskySolver().setup(jp).solve(
        jp.data, jl, LAM))
    _close(dt, dj)
    _close(dt, tg.DenseSolver().setup(tp).solve(tp.data, tl, LAM))


def test_fused_lm_matches_jax():
    g = SCENES["sphere"]()
    g.set_robust_kernel("Huber", 1.0)
    jres = j_optimize_fused(g.compile(), jsc.SparseCholeskySolver(), 10)
    tres = tg.optimize_fused(port_problem(g.compile()),
                             tg.SparseCholeskySolver(), 10)
    assert tres["iterations"] == jres["iterations"] == 10
    np.testing.assert_allclose(tres["chi2_per_iteration"],
                               jres["chi2_per_iteration"], rtol=1e-9)
    assert tres["trials_per_iteration"] == jres["trials_per_iteration"]
    assert tres["chi2_final"] < 0.1 * tres["chi2_per_iteration"][0]


def test_indefinite_hessian_gives_nan_step():
    info = -np.eye(3)
    jp = _two_pose_graph(JGraph, jslam2d, info).compile()
    tp = _two_pose_graph(tg.Graph, tslam2d, info).compile(
        dtype=torch.float64, device="cpu")
    jl = jp.linearize_jit(jp.data, jp.estimates)
    tl = tp.linearize_fn(tp.data, tp.estimates)
    dj = np.asarray(jsc.SparseCholeskySolver().setup(jp).solve(
        jp.data, jl, 0.0))
    dt = tg.SparseCholeskySolver().setup(tp).solve(tp.data, tl, 0.0)
    assert np.isnan(dj).any() and torch.isnan(dt).any()
    res = tg.optimize_fused(tp, tg.SparseCholeskySolver(), 3)
    assert res["iterations"] == 1 and res["trials_per_iteration"] == [10]
