"""Port parity: the square-root ``CGLSSolver`` and ``chol_small``.

The JAX package compiles each scene; ``port_problem`` carries its arrays
into the port (the landmark-bucketed scene is built by each package's own
``create_ba_scene`` and ``compile(bucket_landmarks=True)``, which lay it out
the same way).  Float64 on the CPU:

* one CGLS step at a small ``eta`` against the JAX package's CGLS step
  (≤ 1e-6 relative) and against the port's ``DenseSolver`` (the JAX tests'
  bars: ≤ 1e-6 on the sphere, ≤ 1e-4 on bundle adjustment, ≤ 1e-5 with a
  correlated information matrix — the ``Jt`` adjoint regression);
* a 10-iteration LM with CGLS against the JAX package's, chi2 to rtol 1e-6
  (CG iterations are counted in a different summation order);
* on CPU tensors the bucketed camera slot goes through the plain versions
  of the dims-major gather and segment sum once each per CG iteration,
  and no kernel launch is counted;
* ``chol_small`` equals the JAX closed forms and Cholesky to 1e-12, NaN
  where a block is not positive definite."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import g2o_tpu.types  # noqa: F401
import g2o_tpu_torch as tg
from g2o_tpu.core.graph import Graph as JGraph
from g2o_tpu.core.lm_fused import optimize_fused as j_optimize_fused
from g2o_tpu.core.solvers.cgls import CGLSSolver as JCGLS
from g2o_tpu.ops import lie as jlie
from g2o_tpu.ops.smallblocks import chol_small as j_chol_small
from g2o_tpu.sim.generators import create_ba_scene, create_sphere
from g2o_tpu.types.slam2d import EdgeSE2, VertexSE2
from g2o_tpu_torch.ops import onehot
from g2o_tpu_torch.ops.smallblocks import chol_small
from g2o_tpu_torch.sim.generators import create_ba_scene as t_create_ba_scene
from test_torch_problem import port_problem


def _correlated_chain():
    """An SE2 chain whose information matrices are random SPD with strong
    off-diagonal terms (``tests/test_solvers_extra.py``)."""
    rng = np.random.default_rng(21)
    g = JGraph()
    poses = [np.array([0.3 * i, 0.05 * i, 0.1 * i]) for i in range(12)]
    for i, x in enumerate(poses):
        g.add_vertex(i, VertexSE2, x + rng.normal(scale=0.05, size=3),
                     fixed=(i == 0))
    for i in range(11):
        meas = np.asarray(jlie.se2_compose(
            jlie.se2_inverse(jnp.asarray(poses[i])),
            jnp.asarray(poses[i + 1])))
        A = rng.normal(size=(3, 3))
        g.add_edge(EdgeSE2, [i, i + 1], meas, A @ A.T + 3.0 * np.eye(3))
    return g


def _ba(**kw):
    return create_ba_scene(n_cameras=6, n_points=40, pixel_noise=0.3,
                           point_noise=0.2, seed=9, **kw)


# scene -> (lam, CGLS settings, bar against DenseSolver)
CASES = {
    "sphere": (1e-3, dict(max_iter=2000, eta=1e-18), 1e-6),
    "ba": (1e-2, dict(max_iter=1000, eta=1e-16), 1e-4),
    "ba_bucketed": (1e-2, dict(max_iter=1000, eta=1e-16), 1e-4),
    "correlated_info": (1e-3, dict(max_iter=4000, eta=1e-14), 1e-5),
}


def _problems(case):
    if case == "sphere":
        jp = create_sphere(nodes_per_level=10, laps=4, radius=10.0,
                           seed=7).compile()
        return jp, port_problem(jp)
    if case == "ba":
        jp = _ba()[0].compile()
        return jp, port_problem(jp)
    if case == "ba_bucketed":
        jp = _ba()[0].compile(bucket_landmarks=True)
        tp = t_create_ba_scene(n_cameras=6, n_points=40, pixel_noise=0.3,
                               point_noise=0.2, seed=9)[0].compile(
            bucket_landmarks=True, dtype=torch.float64, device="cpu")
        assert tp.bucket_specs and jp.bucket_specs
        return jp, tp
    jp = _correlated_chain().compile()
    return jp, port_problem(jp)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("case", list(CASES))
def test_cgls_step_matches_jax_and_dense(case):
    lam, kw, bar = CASES[case]
    jp, tp = _problems(case)
    jl = jp.linearize_jit(jp.data, jp.estimates)
    tl = tp.linearize_fn(tp.data, tp.estimates)
    dj = np.asarray(JCGLS(**kw).setup(jp).solve(jp.data, jl, lam))
    s = tg.CGLSSolver(**kw).setup(tp)
    dt = s.solve(tp.data, tl, lam).numpy()
    dd = tg.DenseSolver().setup(tp).solve(tp.data, tl, lam).numpy()
    assert s.solves == 1 and 0 < s.cg_iterations < kw["max_iter"]
    assert _rel(dt, dj) <= 1e-6
    assert _rel(dt, dd) <= bar


def test_cgls_lm_matches_jax():
    g = create_sphere(nodes_per_level=10, laps=4, radius=10.0, seed=7)
    kw = dict(max_iter=200, eta=1e-8)
    jres = j_optimize_fused(g.compile(), JCGLS(**kw), 10)
    tres = tg.optimize_fused(port_problem(g.compile()), tg.CGLSSolver(**kw),
                             10)
    assert tres["iterations"] == jres["iterations"] == 10
    np.testing.assert_allclose(tres["chi2_per_iteration"],
                               jres["chi2_per_iteration"], rtol=1e-6)
    # past iteration 6 the chi2 change is at CG's tolerance, where the
    # packages' summation order may take another trial
    assert tres["trials_per_iteration"][:6] == jres["trials_per_iteration"][:6]
    assert tres["chi2_final"] < 0.1 * tres["chi2_per_iteration"][0]


def test_cgls_bucketed_camera_slot_takes_the_plain_versions_on_cpu(
        monkeypatch):
    _, tp = _problems("ba_bucketed")
    calls = {"gather": 0, "scatter": 0}

    def counted(kind, plain):
        def fn(*args):
            calls[kind] += 1
            return plain(*args)
        return fn

    monkeypatch.setattr(onehot, "onehot_gather_t_plain",
                        counted("gather", onehot.onehot_gather_t_plain))
    monkeypatch.setattr(onehot, "onehot_scatter_add_t_plain",
                        counted("scatter", onehot.onehot_scatter_add_t_plain))
    tl = tp.linearize_fn(tp.data, tp.estimates)
    before = (onehot.onehot_gather_t.launches,
              onehot.onehot_scatter_add_t.launches)
    calls.update(gather=0, scatter=0)
    s = tg.CGLSSolver(max_iter=50, eta=1e-12).setup(tp)
    s.solve(tp.data, tl, 1e-2)
    n_batches = len(tp.bucket_specs)
    assert calls == {"gather": n_batches * s.cg_iterations,
                     "scatter": n_batches * s.cg_iterations}
    assert s.cg_iterations > 0
    assert (onehot.onehot_gather_t.launches,
            onehot.onehot_scatter_add_t.launches) == before


def test_cgls_options():
    with pytest.raises(ValueError, match="matvec_precision"):
        tg.CGLSSolver(matvec_precision="bf16")
    s = tg.CGLSSolver(onehot_max_segments=16, matvec_precision="highest")
    assert (s.max_iter, s.eta, s.onehot_max_segments) == (200, 1e-4, 16)


@pytest.mark.parametrize("r", [1, 2, 3, 6])
def test_chol_small_matches_jax(r):
    rng = np.random.default_rng(r)
    A = rng.standard_normal((5, r, r))
    spd = A @ A.transpose(0, 2, 1) + r * np.eye(r)
    # the last block is not positive definite
    spd[-1] = -np.eye(r)
    got = chol_small(torch.as_tensor(spd)).numpy()
    want = np.asarray(j_chol_small(jnp.asarray(spd)))
    np.testing.assert_allclose(got[:-1], want[:-1], rtol=1e-12, atol=1e-12)
    assert np.isnan(got[-1]).any() and np.isnan(want[-1]).any()
    np.testing.assert_allclose(got[:-1] @ got[:-1].transpose(0, 2, 1),
                               spd[:-1], rtol=1e-12, atol=1e-12)
