"""Port parity: ``PCGSolver`` against the JAX package's, float64.

A 100-pose sphere with ``chunk_size=4`` has nc = 25 chunks, a 150-column
coarse system padded to 192 (> 96): the coarse inverse goes through the K1/K2
dispatch (their plain versions on the CPU).  Solves with ``tol=1e-12`` give
the same dx to rtol 1e-8 (CG amplifies summation-order differences)."""

import jax.numpy as jnp
import numpy as np
import pytest

from g2o_tpu.core.solvers import PCGSolver as JPCG
from g2o_tpu_torch.core.solvers.pcg import PCGSolver as TPCG
from test_torch_problem import port_problem, small_sphere


@pytest.fixture(scope="module")
def pair():
    jp = small_sphere(nodes_per_level=10, laps=10, seed=4).compile()
    tp = port_problem(jp)
    jl = jp.linearize_jit(jp.data, jp.estimates)
    tl = tp.linearize_fn(tp.data, tp.estimates)
    diag = np.asarray(jl.diag["VERTEX_SE3:QUAT"])
    lam = 1e-4 * np.abs(np.diagonal(diag, axis1=1, axis2=2)).max()
    return jp, tp, jl, tl, lam


def _solvers(precond, **kw):
    kw = dict(max_iter=500, tol=1e-12, precond=precond, chunk_size=4,
              absolute_tolerance=False, **kw)
    return JPCG(**kw), TPCG(**kw)


@pytest.mark.parametrize("precond", ["jacobi", "chunk", "chunk2"])
def test_solve_matches(pair, precond):
    jp, tp, jl, tl, lam = pair
    js, ts = _solvers(precond)
    js.setup(jp)
    ts.setup(tp)
    jdx = np.asarray(js.solve(jp.data, jl, jnp.asarray(lam)))
    tdx = ts.solve(tp.data, tl, lam).numpy()
    np.testing.assert_allclose(tdx, jdx, rtol=1e-8,
                               atol=1e-8 * np.abs(jdx).max())
    # the fixed vertex gets no update
    assert np.abs(tdx[:6]).max() == 0.0


def test_coarse_level_matches(pair):
    """The chunk2 coarse inverse (Rᵀ(H+λI)R)⁻¹ itself, 192 x 192."""
    jp, tp, jl, tl, lam = pair
    js, ts = _solvers("chunk2")
    js.setup(jp)
    ts.setup(tp)
    assert ts._chunk["ncd"] == 150 and ts._chunk["ncd_pad"] == 192
    jc = np.asarray(js._dbg_parts["coarse_full"](
        jp.data, jl, jnp.asarray(lam), js.aux["chunk"]))
    minv, tc = ts.build_precond(tp.data, tl, lam)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=1e-9,
                               atol=1e-9 * np.abs(jc).max())
    jm = np.asarray(js._dbg_parts["chunk_blocks"](
        jp.data, jl, jnp.asarray(lam), js.aux["chunk"]))
    np.testing.assert_allclose(minv.numpy(), jm, rtol=1e-9,
                               atol=1e-9 * np.abs(jm).max())


def test_carried_residual_state_matches(pair):
    """absolute_tolerance: the threshold floor carried between solves."""
    jp, tp, jl, tl, lam = pair
    js, ts = _solvers("chunk2", carry_factor=0.5)
    js.absolute_tolerance = ts.absolute_tolerance = True
    js.tol = ts.tol = 1e-3
    js.setup(jp)
    ts.setup(tp)
    jstate, tstate = js.state0, ts.state0
    for _ in range(2):
        jdx, jstate, jst = js._solve_state_jit(jp.data, jl, jnp.asarray(lam),
                                               js.aux, jstate)
        tdx, tstate, tst = ts._solve_state_fn(tp.data, tl, lam, tstate)
        assert tst["cg_iterations"] == int(jst["cg_iterations"])
        np.testing.assert_allclose(float(tstate), float(jstate), rtol=1e-6)
        np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), rtol=1e-6,
                                   atol=1e-6 * np.abs(np.asarray(jdx)).max())
