"""Port parity: the Sim3 group (``ops/lie.py``) and ``types/sim3.py``
against the JAX package, float64 on the CPU.

* the Sim3 ops on random elements: 1e-12 absolute (log(exp(ξ)) = ξ to
  1e-9);
* ``_sim3_W`` against the numerical integral ``∫₀¹ e^{uσ} R(uω) du`` in
  all four branches (1e-12), and its σ-derivative inside the small
  branches against the integral ``∫₀¹ u e^{uσ} R(uω) du`` (1e-6: the
  branches keep the σ-linear terms, so the error is O(σ)) — the W-integral
  regression of the JAX package's ``7fd4264``; just above the σ threshold
  W is ~5e-10 from the integral in both packages (an open fault);
* every Sim3 edge type's residuals and Jacobians on one graph: 1e-10;
  the vertex updates (the FIXSCALE twin included): 1e-12;
* the 11-number ``.g2o`` vertex form and the inverse-log edge form: the
  port reads the JAX package's text to the same states (1e-12) and writes
  it back byte for byte.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import g2o_tpu.types  # noqa: F401
import g2o_tpu_torch.types  # noqa: F401
from g2o_tpu.core.graph import Graph as JGraph
from g2o_tpu.core.types import REGISTRY as JREG
from g2o_tpu.io import g2o_format as jio
from g2o_tpu.ops import lie as jlie
from g2o_tpu.types import sim3 as jsim3
from g2o_tpu.types import slam3d as jslam3d
from g2o_tpu_torch.core.types import REGISTRY as TREG
from g2o_tpu_torch.io import g2o_format as tio
from g2o_tpu_torch.ops import lie as tlie
from test_torch_problem import port_problem

RTOL = 1e-10        # residuals, Jacobians


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * max(np.abs(b).max(), 1e-300))


def _rand_sim3(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.concatenate([rng.normal(size=(n, 3)) * 2, q,
                           np.exp(0.4 * rng.normal(size=(n, 1)))], 1)


def _xi(rng, n):
    x = rng.normal(size=(n, 7)) * 0.5
    # exact zeros, tiny and threshold-straddling sigma / omega
    x[0] = 0.0
    x[1, :3], x[1, 6] = 0.0, 0.3
    x[2, 6] = 0.0
    x[3, :3], x[3, 6] = 1e-9, -2e-9
    x[4, :3], x[4, 6] = 5e-8, 2e-7
    return x


OPS = {
    "sim3_compose": lambda m, a, b, p, x: m.sim3_compose(a, b),
    "sim3_inverse": lambda m, a, b, p, x: m.sim3_inverse(a),
    "sim3_act": lambda m, a, b, p, x: m.sim3_act(a, p),
    "sim3_exp": lambda m, a, b, p, x: m.sim3_exp(x),
    "sim3_log": lambda m, a, b, p, x: m.sim3_log(a),
    "sim3_log_exp": lambda m, a, b, p, x: m.sim3_log(m.sim3_exp(x)),
}


@pytest.mark.parametrize("op", list(OPS))
def test_sim3_op_matches_jax(op):
    rng = np.random.default_rng(4)
    a, b = _rand_sim3(rng, 32), _rand_sim3(rng, 32)
    p, x = rng.normal(size=(32, 3)) * 3, _xi(rng, 32)
    want = np.asarray(OPS[op](jlie, *map(jnp.asarray, (a, b, p, x))))
    got = OPS[op](tlie, *map(torch.tensor, (a, b, p, x))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    if op == "sim3_log_exp":
        # just past the 1e-7 threshold, (e^σ - 1)/σ cancels to ~1e-9 in
        # both packages (as in the reference's sim3.h)
        np.testing.assert_allclose(got, x, rtol=0, atol=1e-9)


def test_sim3_identity():
    e = tlie.sim3_identity((2,))
    np.testing.assert_array_equal(e.numpy(),
                                  np.asarray(jlie.sim3_identity((2,))))


# --------------------------------------------------------------------------- #
# _sim3_W: the W-integral regression
# --------------------------------------------------------------------------- #

def _rodrigues(w):
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th == 0.0:
        return np.eye(3)
    return (np.eye(3) + np.sin(th) / th * K
            + (1 - np.cos(th)) / th ** 2 * K @ K)


def _w_integral(omega, sigma, power=0):
    """∫₀¹ u^power e^{uσ} R(uω) du by 48-point Gauss-Legendre."""
    u, wts = np.polynomial.legendre.leggauss(48)
    u, wts = 0.5 * (u + 1.0), 0.5 * wts
    return sum(w * x ** power * np.exp(x * sigma) * _rodrigues(x * omega)
               for x, w in zip(u, wts))


# (sigma, omega) in each of the four branches of the 1e-7 thresholds
W_CASES = {
    "both_small": (3e-8, np.array([2e-8, -4e-8, 1e-8])),
    "sigma_small": (-6e-8, np.array([0.3, -0.2, 0.5])),
    "theta_small": (0.4, np.array([3e-8, 1e-8, -2e-8])),
    "general": (-0.35, np.array([0.7, 0.1, -0.4])),
}


@pytest.mark.parametrize("case", list(W_CASES))
def test_sim3_W_against_numerical_integral(case):
    sigma, omega = W_CASES[case]
    sig = torch.tensor(sigma, dtype=torch.float64)
    W = tlie._sim3_W(torch.tensor(omega), sig, torch.exp(sig)).numpy()
    np.testing.assert_allclose(W, _w_integral(omega, sigma), rtol=0,
                               atol=1e-12)
    Wj = np.asarray(jlie._sim3_W(jnp.asarray(omega), jnp.asarray(sigma),
                                 jnp.exp(sigma), jnp.float64))
    np.testing.assert_allclose(W, Wj, rtol=0, atol=1e-14)


def test_sim3_W_cancels_just_above_the_sigma_threshold():
    """An open fault shared with the JAX package (ROADMAP C): just above
    σ = 1e-7, A = (e^σ - 1)/σ cancels, so W is ~ε/σ = 5.5e-10 from its
    integral at σ = 2e-7 in both packages, which agree with each other to
    1e-14 there."""
    omega = np.array([1e-7, -1.5e-7, 0.5e-7])
    errs = []
    for sigma in (2e-7, -2e-7):
        sig = torch.tensor(sigma, dtype=torch.float64)
        W = tlie._sim3_W(torch.tensor(omega), sig, torch.exp(sig)).numpy()
        Wj = np.asarray(jlie._sim3_W(jnp.asarray(omega), jnp.asarray(sigma),
                                     jnp.exp(sigma), jnp.float64))
        np.testing.assert_allclose(W, Wj, rtol=0, atol=1e-14)
        errs.append(np.abs(W - _w_integral(omega, sigma)).max())
    assert 1e-11 < max(errs) < 2e-9


@pytest.mark.parametrize("case", ["both_small", "sigma_small"])
def test_sim3_W_sigma_derivative_in_small_branches(case):
    """dW/dσ (s = e^σ) inside the σ ~ 0 branches: the σ-linear terms make
    it right to O(σ); a constant-only branch would give 0 for A and B."""
    sigma, omega = W_CASES[case]
    om = torch.tensor(omega)

    def w_of(sig):
        return tlie._sim3_W(om, sig, torch.exp(sig))

    dW = torch.func.jacfwd(w_of)(torch.tensor(sigma,
                                              dtype=torch.float64)).numpy()
    np.testing.assert_allclose(dW, _w_integral(omega, sigma, power=1),
                               rtol=0, atol=1e-6)
    dWj = np.asarray(jax.jacfwd(lambda s: jlie._sim3_W(
        jnp.asarray(omega), s, jnp.exp(s), jnp.float64))(jnp.asarray(sigma)))
    np.testing.assert_allclose(dW, dWj, rtol=0, atol=1e-12)


def test_sim3_exp_log_gradients_finite_at_identity():
    """Every double-``where`` guard holds under ``torch.func``: the
    Jacobians of exp at 0 and of log at the identity are finite and equal
    to the JAX package's."""
    z = np.zeros(7)
    Jt = torch.func.jacrev(tlie.sim3_exp)(torch.tensor(z)).numpy()
    Jj = np.asarray(jax.jacrev(jlie.sim3_exp)(jnp.asarray(z)))
    assert np.isfinite(Jt).all()
    np.testing.assert_allclose(Jt, Jj, rtol=0, atol=1e-14)
    e = np.asarray(jlie.sim3_identity())
    Lt = torch.func.jacrev(tlie.sim3_log)(torch.tensor(e)).numpy()
    Lj = np.asarray(jax.jacrev(jlie.sim3_log)(jnp.asarray(e)))
    assert np.isfinite(Lt).all()
    np.testing.assert_allclose(Lt, Lj, rtol=0, atol=1e-14)


# --------------------------------------------------------------------------- #
# the Sim3 types
# --------------------------------------------------------------------------- #

def _sim3_graph(G, s3, sl3, seed=2):
    """Sim3 keyframes (0 fixed), points in front of them, Sim3 loop edges,
    both projection edges; the same numbers for either package."""
    rng = np.random.default_rng(seed)
    g = G()
    n = 6
    for i in range(n):
        s = _rand_sim3(rng, 1)[0]
        s[:3] *= 0.3
        intr = np.array([300.0, 310.0, 160.0, 120.0, 290.0, 305.0, 150.0,
                         125.0]) + rng.normal(size=8)
        g.add_vertex(i, s3.VertexSim3Expmap, np.concatenate([s, intr]),
                     fixed=(i == 0))
    for j in range(10):
        g.add_vertex(100 + j, sl3.VertexPointXYZ,
                     np.array([0, 0, 5.0]) + rng.normal(size=3))

    def info(r):
        A = rng.normal(size=(r, r))
        return A @ A.T + r * np.eye(r)

    for i in range(n - 1):
        m = _rand_sim3(rng, 1)[0]
        g.add_edge(s3.EdgeSim3, [i, i + 1], m, info(7))
    g.add_edge(s3.EdgeSim3, [0, n - 1], _rand_sim3(rng, 1)[0], info(7))
    for j in range(10):
        for i in (j % n, (j + 2) % n):
            g.add_edge(s3.EdgeSim3ProjectXYZ, [100 + j, i],
                       rng.uniform(100, 200, 2), info(2))
            g.add_edge(s3.EdgeInverseSim3ProjectXYZ, [100 + j, i],
                       rng.uniform(100, 200, 2), info(2))
    return g


EDGE_NAMES = ["EDGE_SIM3:EXPMAP", "EDGE_PROJECT_SIM3_XYZ:EXPMAP",
              "EDGE_PROJECT_INVERSE_SIM3_XYZ:EXPMAP"]


@pytest.fixture(scope="module")
def lin_pair():
    jg = _sim3_graph(JGraph, jsim3, jslam3d)
    jg.set_robust_kernel("Cauchy", 3.0)
    jp = jg.compile()
    tp = port_problem(jp)
    return (jp, tp, jp.linearize_jit(jp.data, jp.estimates),
            tp.linearize_fn(tp.data, tp.estimates))


@pytest.mark.parametrize("name", EDGE_NAMES)
def test_sim3_edge_residuals_and_jacobians_match(lin_pair, name):
    jp, tp, jl, tl = lin_pair
    _close(tl.errors[name].numpy(), jl.errors[name])
    assert len(tl.jacs[name]) == len(jl.jacs[name]) == 2
    for Jt, Jj in zip(tl.jacs[name], jl.jacs[name]):
        assert np.isfinite(Jt.numpy()).all()
        _close(Jt.numpy(), Jj)


def test_sim3_linearization_and_step_match(lin_pair):
    """b, the diagonal blocks, chi2 and one update of every vertex."""
    jp, tp, jl, tl = lin_pair
    _close(tl.b.numpy(), jl.b)
    for t in jp.vertex_types:
        _close(tl.diag[t].numpy(), jl.diag[t])
    _close(float(tl.chi2_robust), float(jl.chi2_robust))
    dx = np.random.default_rng(0).normal(size=jp.total_dim) * 0.1
    je = jp.apply_jit(jp.data, jp.estimates, jnp.asarray(dx))
    te = tp.apply_update_fn(tp.data, tp.estimates, torch.tensor(dx))
    for t in te:
        np.testing.assert_allclose(te[t].numpy(), np.asarray(je[t]),
                                   rtol=0, atol=1e-12)
    # the intrinsics tail never moves
    s = te["VERTEX_SIM3:EXPMAP"].numpy()
    np.testing.assert_array_equal(
        s[:, 8:], tp.estimates["VERTEX_SIM3:EXPMAP"].numpy()[:, 8:])


@pytest.mark.parametrize("vt", ["VERTEX_SIM3:EXPMAP",
                                "VERTEX_SIM3:EXPMAP:FIXSCALE"])
def test_sim3_vertex_update_matches_jax(vt):
    rng = np.random.default_rng(7)
    x = np.concatenate([_rand_sim3(rng, 16), rng.normal(size=(16, 8))], 1)
    d = rng.normal(size=(16, 7)) * 0.2
    d[0] = 0.0
    jv = JREG.vertex_types[vt]
    tv = TREG.vertex_types[vt]
    want = np.asarray(jv.oplus(jnp.asarray(x), jnp.asarray(d)))
    got = tv.oplus(torch.tensor(x), torch.tensor(d)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    if vt.endswith("FIXSCALE"):
        np.testing.assert_allclose(got[:, 7], x[:, 7], rtol=1e-15)


def test_sim3_text_round_trips_as_in_jax():
    """The 11-number vertex lines and the 7-number inverse-log edge lines:
    the port reads the JAX package's text to its states and measurements
    and writes the same bytes; its own text reads back to itself."""
    jg = _sim3_graph(JGraph, jsim3, jslam3d)
    text = jio.dumps(jg)
    line = next(ln for ln in text.splitlines()
                if ln.startswith("VERTEX_SIM3:EXPMAP "))
    assert len(line.split()) == 2 + 11
    jg2, tg = jio.loads(text), tio.loads(text)
    for vid, rec in jg2.vertices().items():
        np.testing.assert_allclose(tg.vertex(vid).estimate, rec.estimate,
                                   rtol=0, atol=1e-12)
    for a, b in zip(tg.edges(), jg2.edges(), strict=True):
        assert a.etype.name == b.etype.name and a.vids == b.vids
        np.testing.assert_allclose(a.measurement, b.measurement, rtol=0,
                                   atol=1e-12)
        np.testing.assert_array_equal(a.information, b.information)
    assert tio.dumps(tg) == jio.dumps(jg2)
    tg2 = tio.loads(tio.dumps(tg))
    assert tio.dumps(tg2) == tio.dumps(tg)
