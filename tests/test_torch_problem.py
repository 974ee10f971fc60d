"""Port parity: ``g2o_tpu_torch.core.problem`` against ``g2o_tpu.core.problem``.

A small Huber sphere is compiled by the JAX package; its arrays are carried
into the port by ``problem_from_numpy``, so both packages work on exactly
the same numbers.  Errors, Jacobians, robust weights, b, diagonal blocks,
robust and plain chi2, ``hvp_operator`` and ``apply_update_fn`` agree at
float64 to rtol 1e-9 (same formulas, different summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import g2o_tpu.types  # noqa: F401
from g2o_tpu.ops import robust as jrobust
from g2o_tpu.sim.generators import create_sphere
from g2o_tpu_torch.core.problem import problem_from_numpy
from g2o_tpu_torch.ops import robust as trobust

RTOL = 1e-9


def port_problem(jp, dtype=torch.float64, device="cpu"):
    """The port's Problem over a JAX Problem's arrays."""
    vertices = {t: (np.asarray(jp.estimates[t]), np.asarray(jp.data.fixed[t]))
                for t in jp.vertex_types}
    edges = {name: {f: np.asarray(getattr(b, f)) for f in b._fields}
             for name, b in jp.data.edges.items()}
    return problem_from_numpy(vertices, edges, dtype=dtype, device=device,
                              vid_index=dict(jp.vid_index))


def small_sphere(kernel="Huber", nodes_per_level=10, laps=5, seed=0):
    g = create_sphere(nodes_per_level=nodes_per_level, laps=laps, seed=seed)
    if kernel is not None:
        g.set_robust_kernel(kernel, 1.0)
    return g


def _close(a, b, rtol=RTOL):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    scale = max(np.abs(b).max(), 1e-300) if b.size else 1.0
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale)


@pytest.fixture(scope="module")
def pair():
    jp = small_sphere().compile()
    return jp, port_problem(jp)


def test_layout_matches(pair):
    jp, tp = pair
    assert tp.counts == jp.counts and tp.total_dim == jp.total_dim
    assert tp.type_bases == jp.type_bases
    assert tp.uniform_kernel == jp.uniform_kernel
    assert tp.num_edges == jp.num_edges


def test_linearize_matches(pair):
    jp, tp = pair
    jl = jp.linearize_jit(jp.data, jp.estimates)
    tl = tp.linearize_fn(tp.data, tp.estimates)
    for name in jp.edge_types:
        _close(tl.errors[name], jl.errors[name])
        _close(tl.weights[name], jl.weights[name])
        for Jt, Jj in zip(tl.jacs[name], jl.jacs[name], strict=True):
            _close(Jt, Jj)
    _close(tl.b, jl.b)
    for t in jp.vertex_types:
        _close(tl.diag[t], jl.diag[t])
    _close(tl.chi2_robust, jl.chi2_robust)
    _close(tl.chi2, jl.chi2)
    # the Huber kernel is active on some edges and not on others
    w = tl.weights["EDGE_SE3:QUAT"]
    info = tp.data.edges["EDGE_SE3:QUAT"].info
    ratio = w[:, 0, 0] / info[:, 0, 0]
    assert (ratio < 1).any() and (ratio == 1).any()


def test_chi2_matches(pair):
    jp, tp = pair
    jr, jc = jp.chi2_jit(jp.data, jp.estimates)
    tr, tc = tp.chi2_fn(tp.data, tp.estimates)
    _close(tr, jr)
    _close(tc, jc)
    assert float(tr) < float(tc)


def test_hvp_operator_matches(pair):
    jp, tp = pair
    rng = np.random.default_rng(0)
    v = rng.standard_normal(jp.total_dim)
    jl = jp.linearize_jit(jp.data, jp.estimates)
    tl = tp.linearize_fn(tp.data, tp.estimates)
    jh = jp.join_tangent(jp.hvp_operator(jp.data, jl)(
        jp.split_tangent(jnp.asarray(v))))
    th = tp.join_tangent(tp.hvp_operator(tp.data, tl)(
        tp.split_tangent(torch.as_tensor(v))))
    _close(th, jh)
    # H·v is symmetric positive semidefinite: vᵀHv >= 0
    assert float(torch.dot(th, torch.as_tensor(v))) >= 0


def test_apply_update_matches(pair):
    jp, tp = pair
    rng = np.random.default_rng(1)
    dx = rng.standard_normal(jp.total_dim) * 0.05
    je = jp.apply_jit(jp.data, jp.estimates, jnp.asarray(dx))
    te = tp.apply_update_fn(tp.data, tp.estimates, torch.as_tensor(dx))
    for t in jp.vertex_types:
        _close(te[t], je[t])
    # the fixed vertex 0 does not move
    _close(te["VERTEX_SE3:QUAT"][0], jp.estimates["VERTEX_SE3:QUAT"][0])


def test_padding_and_inactive_edges():
    """Padded rows and inactive edges contribute nothing, as in the JAX
    package; mixed kernels take the per-edge dispatch."""
    g = small_sphere(nodes_per_level=6, laps=3, seed=2)
    edges = g.edges()
    edges[3].active = False
    edges[5].kernel = jrobust.CAUCHY
    jp = g.compile(pad_edges_to_multiple=8)
    tp = port_problem(jp)
    assert tp.uniform_kernel["EDGE_SE3:QUAT"] is None
    jl = jp.linearize_jit(jp.data, jp.estimates)
    tl = tp.linearize_fn(tp.data, tp.estimates)
    _close(tl.b, jl.b)
    _close(tl.chi2_robust, jl.chi2_robust)
    for t in jp.vertex_types:
        _close(tl.diag[t], jl.diag[t])


def test_prior_edge_forward_mode_matches():
    """EDGE_SE3_PRIOR (r = 6 = Σd: forward-mode Jacobians) with a
    PARAMS_SE3OFFSET parameter, read from one text by both loaders."""
    from g2o_tpu.io import g2o_format as jio
    from g2o_tpu_torch.io import g2o_format as tio

    g = small_sphere(nodes_per_level=6, laps=3, seed=3)
    text = jio.dumps(g) + (
        "PARAMS_SE3OFFSET 0 0.1 -0.2 0.3 0.0499792 0 0 0.99875\n"
        "EDGE_SE3_PRIOR 5 0 1 2 3 0 0 0 1 "
        + " ".join(["10", "0", "0", "0", "0", "0", "10", "0", "0", "0",
                    "0", "10", "0", "0", "0", "40", "0", "0", "40", "0",
                    "40"]) + "\n")
    jg, tg = jio.loads(text), tio.loads(text)
    jp = jg.compile()
    tp = tg.compile(dtype=torch.float64)
    assert set(tp.edge_types) == {"EDGE_SE3:QUAT", "EDGE_SE3_PRIOR"}
    jl = jp.linearize_jit(jp.data, jp.estimates)
    tl = tp.linearize_fn(tp.data, tp.estimates)
    for Jt, Jj in zip(tl.jacs["EDGE_SE3_PRIOR"], jl.jacs["EDGE_SE3_PRIOR"],
                      strict=True):
        _close(Jt, Jj)
    _close(tl.errors["EDGE_SE3_PRIOR"], jl.errors["EDGE_SE3_PRIOR"])
    _close(tl.b, jl.b)
    _close(tl.chi2, jl.chi2)
    assert "PARAMS_SE3OFFSET 0" in tio.dumps(tg)


@pytest.mark.parametrize("name", sorted(k for k in trobust.KERNEL_IDS if k))
def test_robust_kernel_matches(name):
    kid = trobust.KERNEL_IDS[name]
    rng = np.random.default_rng(kid)
    e2 = np.concatenate([rng.uniform(0, 4, 40), [0.0, 1.0, 1e-12, 30.0]])
    delta = np.full_like(e2, 1.3)
    ref = np.asarray(jrobust.robustify(kid, jnp.asarray(e2),
                                       jnp.asarray(delta)))
    out = trobust.robustify(kid, torch.as_tensor(e2), torch.as_tensor(delta))
    finite = np.isfinite(ref)
    assert (np.isfinite(out.numpy()) == finite).all()
    _close(out.numpy()[finite], ref[finite], rtol=1e-12)
    # the per-edge dispatch picks the same rows
    ids = np.full(e2.shape, kid, dtype=np.int32)
    ids[::3] = jrobust.HUBER
    refb = np.asarray(jrobust.robustify_batch(jnp.asarray(ids),
                                              jnp.asarray(e2),
                                              jnp.asarray(delta)))
    outb = trobust.robustify_batch(torch.as_tensor(ids), torch.as_tensor(e2),
                                   torch.as_tensor(delta)).numpy()
    finite = np.isfinite(refb)
    _close(outb[finite], refb[finite], rtol=1e-12)


def test_build_problem_rejects_unknown_vertex():
    from g2o_tpu_torch.core.problem import build_problem

    est = np.tile([0, 0, 0, 0, 0, 0, 1.0], (2, 1))
    with pytest.raises(ValueError, match="unknown vertex id 7"):
        build_problem(
            {"VERTEX_SE3:QUAT": (np.array([0, 1]), est, np.zeros(2, bool))},
            {"EDGE_SE3:QUAT": (np.array([[0, 7]]), est[:1], np.eye(6)[None],
                               np.zeros(1), np.ones(1), np.ones(1, bool),
                               np.zeros((1, 0)))})
