"""Port parity: ``g2o_tpu_torch.ops.lie`` (SO3/SE3) against ``g2o_tpu.ops.lie``
at float64, inputs from a numpy seed.  Values agree to rtol 1e-12 (the same
formulas, evaluated in another order by another library); the Jacobians of
an SE3 edge residual through ``se3_oplus`` at zero perturbation agree to
1e-10 and are finite, including at zero residual and near-zero angles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2o_tpu.ops import lie as jlie
from g2o_tpu_torch.ops import lie as tlie

RTOL = 1e-12
ATOL = 1e-13


def _quats(rng, n):
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    # near-identity rotations (both signs of w) and half-turns about each
    # axis, which select every branch of quat_from_matrix
    q[0] = [1e-9, -2e-9, 3e-10, 1.0]
    q[1] = [0.0, 0.0, 0.0, -1.0]
    q[2] = [1.0, 0.0, 0.0, 1e-7]
    q[3] = [0.0, 1.0, 0.0, 0.0]
    q[4] = [0.0, 0.0, 1.0, -1e-8]
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _inputs(seed=0, n=24):
    rng = np.random.default_rng(seed)
    q = _quats(rng, n)
    q2 = _quats(rng, n)[::-1].copy()
    t = rng.standard_normal((n, 3)) * 5
    v = rng.standard_normal((n, 3))
    small = rng.standard_normal((n, 3)) * 0.3
    small[:3] *= 1e-9
    small[3] = 0.0
    x = np.concatenate([t, q], axis=1)
    y = np.concatenate([v, q2], axis=1)
    mqt = np.concatenate([v, small], axis=1)
    xi = np.concatenate([small, v], axis=1)
    R = np.array(jlie.quat_to_matrix(jnp.asarray(q)))
    return dict(q=q, q2=q2, v=v, small=small, x=x, y=y, mqt=mqt, xi=xi, R=R)


CASES = {
    "quat_mul": ("q", "q2"),
    "quat_conj": ("q",),
    "quat_normalize": ("q",),
    "quat_positive": ("q",),
    "quat_rotate": ("q", "v"),
    "quat_to_matrix": ("q",),
    "quat_from_matrix": ("R",),
    "quat_to_compact": ("q",),
    "quat_from_compact": ("small",),
    "so3_exp": ("small",),
    "so3_log": ("q",),
    "so3_hat": ("v",),
    "se3_compose": ("x", "y"),
    "se3_inverse": ("x",),
    "se3_act": ("x", "v"),
    "se3_normalize": ("x",),
    "se3_to_mqt": ("x",),
    "se3_from_mqt": ("mqt",),
    "se3_oplus": ("x", "mqt"),
    "se3quat_exp": ("xi",),
    "se3quat_log": ("x",),
}


@pytest.mark.parametrize("fn", sorted(CASES))
def test_lie_function_matches_jax(fn):
    inp = _inputs()
    args = [inp[k] for k in CASES[fn]]
    ref = np.asarray(getattr(jlie, fn)(*[jnp.asarray(a) for a in args]))
    out = getattr(tlie, fn)(*[torch.as_tensor(a) for a in args]).numpy()
    assert out.dtype == np.float64
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_from_compact_out_of_ball_is_identity():
    v = np.array([[0.9, 0.9, 0.0], [0.1, 0.2, 0.3]])
    out = tlie.quat_from_compact(torch.as_tensor(v)).numpy()
    np.testing.assert_allclose(out[0], [0, 0, 0, 1])
    np.testing.assert_allclose(
        out, np.asarray(jlie.quat_from_compact(jnp.asarray(v))), rtol=RTOL)


def _edge_residual(lie, xi, xj, meas):
    def f(di, dj):
        a = lie.se3_oplus(xi, di)
        b = lie.se3_oplus(xj, dj)
        delta = lie.se3_compose(lie.se3_inverse(a), b)
        return lie.se3_to_mqt(lie.se3_compose(lie.se3_inverse(meas), delta))
    return f


@pytest.mark.parametrize("case", ["generic", "zero_residual", "tiny_angle"])
def test_se3_edge_jacobian_at_zero_perturbation(case):
    """Reverse-mode Jacobian of an EDGE_SE3-style residual composed with
    ``se3_oplus``: finite (the double-where guards) and equal to JAX's."""
    inp = _inputs(seed=1, n=8)
    xi, xj = inp["x"][5], inp["y"][6]
    if case == "generic":
        meas = inp["x"][7]
    else:
        rel = np.asarray(jlie.se3_compose(jlie.se3_inverse(jnp.asarray(xi)),
                                          jnp.asarray(xj)))
        meas = rel
        if case == "tiny_angle":
            meas = np.asarray(jlie.se3_compose(
                jnp.asarray(rel),
                jlie.se3_from_mqt(jnp.asarray([1e-7, 0, 0, 1e-10, 0, 2e-10]))))
    zero = np.zeros(6)
    jf = _edge_residual(jlie, *(jnp.asarray(a) for a in (xi, xj, meas)))
    ref = np.stack([np.asarray(J) for J in
                    jax.jacrev(jf, argnums=(0, 1))(jnp.asarray(zero),
                                                   jnp.asarray(zero))])
    tf = _edge_residual(tlie, *(torch.tensor(a) for a in (xi, xj, meas)))
    out = np.stack([J.numpy() for J in torch.func.jacrev(
        tf, argnums=(0, 1))(torch.zeros(6, dtype=torch.float64),
                            torch.zeros(6, dtype=torch.float64))])
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("fn", ["quat_identity", "se3_identity"])
def test_identity_matches_jax(fn):
    ref = np.asarray(getattr(jlie, fn)((2, 3)))
    out = getattr(tlie, fn)((2, 3)).numpy()
    np.testing.assert_array_equal(out, ref)
