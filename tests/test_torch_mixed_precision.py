"""Mixed precision (``state_dtype`` wider than ``dtype``) and the precision
knobs of the port against the JAX package, on the CPU.

* The wide linearization: ``compile(dtype=float32, state_dtype=float64)``
  keeps estimates, measurements, information and parameters at float64,
  linearizes at float64 and rounds the solver-facing leaves to float32
  once.  Its leaves — Jacobians, robust weights, errors, ``b``, diagonal
  blocks and, bucketed, the extras — hold the JAX package's to rtol 1e-6
  of each leaf's scale (a float32 rounding of float64 values that differ
  in summation order lands at most one float32 step apart), chi2 to rtol
  1e-12; on ``create_manhattan(250, seed=5)`` (flat) and a small bundle
  adjustment scene built with ``bucket_landmarks=True``.
* The Gauss-Newton fixed point: 8 iterations of ``optimize_fused_gn`` with
  ``DenseSolver`` on ``create_manhattan(250, seed=5)``; the mixed run
  within 1e-4 of the float64 run (the JAX test's bar) and within 1e-6
  relative of the JAX package's mixed run.
* ``PCGSolver(precond_dtype=float32)`` (accepted; the card runs float64
  natively) solves the float64 system within 1e-4 of the JAX package's
  dense solution in norm, as the JAX test asks of its own.
* ``hvp``: float64 against float32 within 1e-4 of the scale (the JAX
  test's bar), and the float64 product against the JAX package's to rtol
  1e-9.
* Fault C.7, the mixed ``SupernodalCholeskySolver``: on
  ``create_manhattan(300, seed=0)`` both packages' first steps within 1e-3
  of the float64 dense step; on ``create_manhattan(3500, seed=0)``, where
  the JAX package's Gauss-Newton run stops at a non-finite chi2, the
  port's mixed run reaches the float64 chi2 within 1e-4 in 12 iterations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import g2o_tpu.types  # noqa: F401
import g2o_tpu_torch as tg2o
from g2o_tpu.core.lm_fused import optimize_fused_gn as j_optimize_fused_gn
from g2o_tpu.core.solvers import DenseSolver as JDense
from g2o_tpu.core.solvers import SupernodalCholeskySolver as JSupernodal
from g2o_tpu.sim import generators as jgen
from g2o_tpu_torch.sim import generators as tgen

F32, F64 = torch.float32, torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs six worker processes on a shared
    host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu(g, **kw):
    return g.compile(device="cpu", **kw)


def _leaves(x, path=""):
    """``{path: array}`` of a nested dict / tuple of arrays or tensors."""
    if isinstance(x, dict):
        out = {}
        for k in sorted(x):
            out.update(_leaves(x[k], f"{path}/{k}"))
        return out
    if isinstance(x, (tuple, list)):
        out = {}
        for i, v in enumerate(x):
            out.update(_leaves(v, f"{path}/{i}"))
        return out
    return {path: x}


def _check_leaves(tlin, jlin):
    for field in ("jacs", "weights", "errors", "b", "diag", "extras"):
        tl = _leaves(getattr(tlin, field))
        jl = _leaves(getattr(jlin, field))
        assert set(tl) == set(jl), field
        for k, v in tl.items():
            assert v.dtype == F32, (field, k, v.dtype)
            want = np.asarray(jl[k])
            assert want.dtype == np.float32, (field, k)
            scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.
            np.testing.assert_allclose(v.numpy(), want, rtol=1e-6,
                                       atol=1e-6 * scale,
                                       err_msg=f"{field}{k}")
    for field in ("chi2_robust", "chi2"):
        got = getattr(tlin, field)
        assert got.dtype == F64
        np.testing.assert_allclose(float(got), float(getattr(jlin, field)),
                                   rtol=1e-12)


def test_mixed_linearize_leaves_match_jax_flat():
    jp = jgen.create_manhattan(n_poses=250, seed=5).compile(
        dtype=jnp.float32, state_dtype=jnp.float64)
    tp = _cpu(tgen.create_manhattan(n_poses=250, seed=5), dtype=F32,
              state_dtype=F64)
    assert tp.dtype == F32 and tp.state_dtype == F64
    for t, v in tp.estimates.items():
        assert v.dtype == F64
        np.testing.assert_array_equal(v.numpy(), np.asarray(jp.estimates[t]))
    for b in tp.data.edges.values():
        assert b.meas.dtype == b.info.dtype == b.param.dtype == F64
    assert tp.data.fixed_flat.dtype == F32
    _check_leaves(tp.linearize_fn(tp.data, tp.estimates),
                  jp.linearize_jit(jp.data, jp.estimates))
    r_t = tp.chi2_fn(tp.data, tp.estimates)
    r_j = jp.chi2_fn(jp.data, jp.estimates)
    assert r_t[0].dtype == F64
    np.testing.assert_allclose(float(r_t[0]), float(r_j[0]), rtol=1e-12)
    dx = torch.full((tp.total_dim,), 1e-3, dtype=F32)
    up_t = tp.apply_update_fn(tp.data, tp.estimates, dx)
    up_j = jp.apply_update_fn(jp.data, jp.estimates, jnp.asarray(dx.numpy()))
    for t, v in up_t.items():
        assert v.dtype == F64
        np.testing.assert_allclose(v.numpy(), np.asarray(up_j[t]),
                                   rtol=1e-12, atol=1e-15)


def test_mixed_linearize_leaves_match_jax_bucketed():
    kw = dict(n_cameras=6, n_points=80, pixel_noise=0.5, point_noise=0.2,
              seed=3)
    jp = jgen.create_ba_scene(**kw)[0].compile(
        bucket_landmarks=True, dtype=jnp.float32, state_dtype=jnp.float64)
    tp = _cpu(tgen.create_ba_scene(**kw)[0], bucket_landmarks=True,
              dtype=F32, state_dtype=F64)
    assert tp.bucket_specs
    tlin = tp.linearize_fn(tp.data, tp.estimates)
    assert set(tlin.extras[next(iter(tp.bucket_specs))]) >= {
        "Bt", "bl_bucket", "Hll_bucket", "bl_bucket_t", "Hll_bucket_t"}
    _check_leaves(tlin, jp.linearize_jit(jp.data, jp.estimates))


def test_wide_linearize_reaches_f64_fixed_point():
    """The JAX package's test, on both packages: the mixed GN + dense run
    lands on the float64 fixed point."""
    g_j = jgen.create_manhattan(n_poses=250, seed=5)
    g_t = tgen.create_manhattan(n_poses=250, seed=5)
    c_jmx = float(j_optimize_fused_gn(
        g_j.compile(dtype=jnp.float32, state_dtype=jnp.float64), JDense(),
        8)["chi2_final"])
    c64 = float(tg2o.optimize_fused_gn(_cpu(g_t, dtype=F64),
                                       tg2o.DenseSolver(), 8)["chi2_final"])
    pmx = tg2o.Graph.compile(g_t, dtype=F32, state_dtype=F64, device="cpu")
    res = tg2o.optimize_fused_gn(pmx, tg2o.DenseSolver(), 8)
    cmx = float(res["chi2_final"])
    assert pmx.estimates[next(iter(pmx.estimates))].dtype == F64
    assert abs(cmx - c64) <= 1e-4 * max(c64, 1.0)
    assert abs(cmx - c_jmx) <= 1e-6 * c_jmx


def test_precond_dtype_f32_matches_f64_precond():
    jp = jgen.create_manhattan(n_poses=250, seed=5).compile(dtype=jnp.float64)
    jlin = jp.linearize_jit(jp.data, jp.estimates)
    ref = np.asarray(JDense().setup(jp).solve(jp.data, jlin,
                                              jnp.asarray(1e-3, jp.dtype)))
    nref = np.linalg.norm(ref)
    tp = _cpu(tgen.create_manhattan(n_poses=250, seed=5), dtype=F64)
    lin = tp.linearize_fn(tp.data, tp.estimates)
    for pd in (None, F32):
        s = tg2o.PCGSolver(max_iter=2048, tol=1e-10, precond="chunk2",
                           chunk_size=16, carry_factor=0.0, precond_dtype=pd)
        x = s.setup(tp).solve(tp.data, lin, 1e-3).numpy()
        assert np.linalg.norm(x - ref) <= 1e-4 * nref, pd


def test_hvp_f64_broadcast_matches_einsum_form():
    g_t = tgen.create_manhattan(n_poses=120, seed=2)
    p64, p32 = _cpu(g_t, dtype=F64), _cpu(g_t, dtype=F32)
    v = np.random.default_rng(0).standard_normal(p64.total_dim)
    h64 = p64.hvp_fn(p64.data, p64.linearize_fn(p64.data, p64.estimates),
                     torch.as_tensor(v)).numpy()
    h32 = p32.hvp_fn(p32.data, p32.linearize_fn(p32.data, p32.estimates),
                     torch.as_tensor(v, dtype=F32)).numpy()
    assert np.abs(h64 - h32).max() <= 1e-4 * np.abs(h64).max()
    jp = jgen.create_manhattan(n_poses=120, seed=2).compile(dtype=jnp.float64)
    hj = np.asarray(jp.hvp_fn(jp.data, jp.linearize_jit(jp.data,
                                                        jp.estimates),
                              jnp.asarray(v)))
    np.testing.assert_allclose(h64, hj, rtol=1e-9,
                               atol=1e-9 * np.abs(hj).max())


def test_mixed_supernodal_first_step_c7():
    """Fault C.7: the float32 supernodal solve of a mixed manhattan
    problem's first linearization.  Both packages' steps (the factor, the
    sweeps and one refinement sweep) land within 1e-3 of the float64 dense
    step, the same accuracy class: the two packages run one algorithm and
    part only by float32 rounding (ROADMAP C.7)."""
    jp = jgen.create_manhattan(n_poses=300, seed=0).compile(
        dtype=jnp.float32, state_dtype=jnp.float64)
    j64 = jgen.create_manhattan(n_poses=300, seed=0).compile(
        dtype=jnp.float64)
    ref = np.asarray(JDense().setup(j64).solve(
        j64.data, j64.linearize_jit(j64.data, j64.estimates), 0.0))
    dx_j = np.asarray(JSupernodal().setup(jp).solve(
        jp.data, jp.linearize_jit(jp.data, jp.estimates), 0.0))
    tp = _cpu(tgen.create_manhattan(n_poses=300, seed=0), dtype=F32,
              state_dtype=F64)
    s = tg2o.SupernodalCholeskySolver().setup(tp)
    dx_t = s.solve(tp.data, tp.linearize_fn(tp.data, tp.estimates), 0.0)
    assert dx_t.dtype == F32
    for dx in (dx_j, dx_t.numpy()):
        rel = np.linalg.norm(dx.astype(np.float64) - ref) / np.linalg.norm(ref)
        assert rel <= 1e-3, rel


def test_mixed_supernodal_gn_reaches_f64_chi2_c7():
    """Fault C.7 where the JAX package stops: ``create_manhattan(3500,
    seed=0)`` compiled ``dtype=float32, state_dtype=float64`` with
    ``SupernodalCholeskySolver`` and ``optimize_fused_gn``.  The port's
    mixed run reaches the float64 run's chi2 within 1e-4 (the JAX test's
    bar) in 12 iterations; the JAX package's stops after 2 at a non-finite
    chi2, its factor of the third linearization meeting a non-positive
    pivot that the port's factor of the same linearization does not."""
    g = tgen.create_manhattan(n_poses=3500, seed=0)
    c64 = tg2o.optimize_fused_gn(_cpu(g, dtype=F64),
                                 tg2o.SupernodalCholeskySolver(),
                                 8)["chi2_final"]
    res = tg2o.optimize_fused_gn(_cpu(g, dtype=F32, state_dtype=F64),
                                 tg2o.SupernodalCholeskySolver(), 12)
    assert res["iterations"] == 12
    assert abs(res["chi2_final"] - c64) <= 1e-4 * c64
