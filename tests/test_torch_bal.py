"""Port parity: the BAL types and IO (``g2o_tpu_torch.types.bal``,
``g2o_tpu_torch.io.bal``) against the JAX package, float64 on the CPU.

Tolerances: projections and rotations to rtol 1e-12 (the same formulas);
residuals, Jacobians, ``b`` and the Hessian diagonal blocks of the C20 file
to rtol 1e-9 of the largest entry (the bound of ``test_torch_problem.py``);
the generators' parsed arrays to 1e-6 (the files print pixels with six
decimals, so one rounding of a last digit is the most two float64
projections can differ by)."""

import gzip
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacrev

import g2o_tpu.types  # noqa: F401
from g2o_tpu.io import bal as jbal
from g2o_tpu.types import bal as jtypes
from g2o_tpu_torch.io import bal as tbal
from g2o_tpu_torch.types import bal as ttypes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C20 = os.path.join(ROOT, "data", "bal_cache", "bal-C20-P800-K5-N1-S0.txt.gz")
RTOL = 1e-9


def _close(a, b, rtol=RTOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    scale = max(np.abs(b).max(), 1e-300) if b.size else 1.0
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale)


@pytest.fixture(scope="module")
def text():
    with gzip.open(C20, "rt") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def pair(text):
    jp = jbal.load_bal_problem(io.StringIO(text))
    tp = tbal.load_bal_problem(io.StringIO(text), device="cpu")
    return jp, tp


def _cameras_and_points(omega_scale, n=16, seed=0):
    rng = np.random.default_rng(seed)
    cams = np.zeros((n, 9))
    cams[:, :3] = omega_scale * rng.standard_normal((n, 3))
    cams[:, 3:6] = rng.standard_normal((n, 3)) + [0.0, 0.0, -10.0]
    cams[:, 6] = 800.0
    cams[:, 7] = -1e-7
    cams[:, 8] = 1e-13
    pts = rng.uniform(-3, 3, (n, 3))
    return cams, pts


@pytest.mark.parametrize("omega_scale", [0.3, 1e-8, 0.0])
def test_projection_matches_jax(omega_scale):
    """Rotation and projection agree at a generic angle, below the Taylor
    switch (|ω| < 1e-7) and at ω = 0 exactly."""
    cams, pts = _cameras_and_points(omega_scale)
    _close(ttypes.rodrigues_rotate(torch.as_tensor(cams[:, :3]),
                                   torch.as_tensor(pts)),
           jtypes.rodrigues_rotate(jnp.asarray(cams[:, :3]), jnp.asarray(pts)),
           rtol=1e-12)
    _close(ttypes.bal_project(torch.as_tensor(cams), torch.as_tensor(pts)),
           jtypes.bal_project(jnp.asarray(cams), jnp.asarray(pts)),
           rtol=1e-12)


@pytest.mark.parametrize("omega_scale", [0.3, 1e-8, 0.0])
def test_projection_jacobian_is_finite_and_matches_jax(omega_scale):
    """The derivative-safe angle keeps autodiff finite at ω = 0 (camera 24
    of the ladybug file sits there) and equal to the JAX package's."""
    cams, pts = _cameras_and_points(omega_scale, n=4, seed=1)
    for c, x in zip(cams, pts):
        jt = jacrev(ttypes.bal_project, argnums=(0, 1))(
            torch.as_tensor(c), torch.as_tensor(x))
        jj = jax.jacfwd(jtypes.bal_project, argnums=(0, 1))(
            jnp.asarray(c), jnp.asarray(x))
        for a, b in zip(jt, jj, strict=True):
            assert torch.isfinite(a).all()
            _close(a, b, rtol=1e-10)


def test_linearize_matches_jax_on_c20(pair):
    jp, tp = pair
    jl = jp.linearize_jit(jp.data, jp.estimates)
    tl = tp.linearize_fn(tp.data, tp.estimates)
    name = "EDGE_OBSERVATION_BAL"
    _close(tl.errors[name], jl.errors[name])
    assert len(tl.jacs[name]) == 2
    for Jt, Jj in zip(tl.jacs[name], jl.jacs[name], strict=True):
        _close(Jt, Jj)
    _close(tl.b, jl.b)
    for t in jp.vertex_types:
        _close(tl.diag[t], jl.diag[t])
    _close(tl.chi2, jl.chi2)
    _close(tl.chi2_robust, jl.chi2_robust)


@pytest.mark.parametrize("fix_first_camera,huber", [(False, 0.0), (True, 1.0)])
def test_load_bal_problem_arrays_and_layout(text, fix_first_camera, huber):
    kw = dict(fix_first_camera=fix_first_camera, huber=huber)
    jp = jbal.load_bal_problem(io.StringIO(text), **kw)
    tp = tbal.load_bal_problem(io.StringIO(text), device="cpu", **kw)
    assert list(tp.vertex_types) == list(jp.vertex_types) == [
        "VERTEX_CAMERA_BAL", "VERTEX_TRACKXYZ"]
    assert tp.counts == jp.counts == {"VERTEX_CAMERA_BAL": 20,
                                      "VERTEX_TRACKXYZ": 800}
    assert tp.type_bases == jp.type_bases
    assert tp.total_dim == jp.total_dim == 20 * 9 + 800 * 3
    assert tp.vid_index == jp.vid_index
    assert tp.uniform_kernel == jp.uniform_kernel
    for t in jp.vertex_types:
        np.testing.assert_array_equal(tp.data.offsets[t].numpy(),
                                      np.asarray(jp.data.offsets[t]))
        np.testing.assert_array_equal(tp.data.fixed[t].numpy(),
                                      np.asarray(jp.data.fixed[t]))
        np.testing.assert_array_equal(tp.marginalized[t], jp.marginalized[t])
        np.testing.assert_array_equal(tp.estimates[t].numpy(),
                                      np.asarray(jp.estimates[t]))
    np.testing.assert_array_equal(tp.data.fixed_flat.numpy(),
                                  np.asarray(jp.data.fixed_flat))
    assert tp.data.fixed_flat.sum() == 9 * fix_first_camera
    jb, tb = jp.data.edges["EDGE_OBSERVATION_BAL"], \
        tp.data.edges["EDGE_OBSERVATION_BAL"]
    for f in ("vidx", "meas", "info", "kernel", "delta", "active"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)


def test_load_bal_graph_matches_jax(text):
    jg = jbal.load_bal(io.StringIO(text), huber=2.0)
    tg = tbal.load_bal(io.StringIO(text), huber=2.0)
    assert sorted(tg.vertices()) == sorted(jg.vertices())
    for vid, rec in jg.vertices().items():
        trec = tg.vertex(vid)
        assert trec.vtype.name == rec.vtype.name
        assert (trec.fixed, trec.marginalized) == (rec.fixed, rec.marginalized)
        np.testing.assert_array_equal(trec.estimate, rec.estimate)
    for te, je in zip(tg.edges(), jg.edges(), strict=True):
        assert te.vids == je.vids and (te.kernel, te.delta) == (je.kernel,
                                                                je.delta)
        np.testing.assert_array_equal(te.measurement, je.measurement)
    # the graph compiles to the arrays of the array-direct loader
    tp = tg.compile(dtype=torch.float64, device="cpu")
    ta = tbal.load_bal_problem(io.StringIO(text), huber=2.0, device="cpu")
    for t in tp.vertex_types:
        np.testing.assert_array_equal(tp.marginalized[t], ta.marginalized[t])
        np.testing.assert_array_equal(tp.estimates[t].numpy(),
                                      ta.estimates[t].numpy())


def test_save_load_round_trip(text, tmp_path):
    tg = tbal.load_bal(io.StringIO(text))
    rng = np.random.default_rng(2)
    est = {vid: rec.estimate + 1e-3 * rng.standard_normal(rec.estimate.shape)
           for vid, rec in tg.vertices().items()}
    path = tmp_path / "out.bal"
    tbal.save_bal(tg, path, estimates_by_vid=est)
    back = tbal.load_bal(str(path))
    jback = jbal.load_bal(str(path))
    # values are written with 16 significant digits
    for vid, rec in back.vertices().items():
        np.testing.assert_allclose(rec.estimate, est[vid], rtol=1e-15)
        np.testing.assert_array_equal(jback.vertex(vid).estimate,
                                      rec.estimate)
    assert [e.vids for e in back.edges()] == [e.vids for e in tg.edges()]
    # without new estimates the text is the JAX package's byte for byte
    jpath = tmp_path / "jax.bal"
    tbal.save_bal(tg, tmp_path / "port.bal")
    jbal.save_bal(jbal.load_bal(io.StringIO(text)), jpath)
    assert (tmp_path / "port.bal").read_text() == jpath.read_text()


def test_bal_gauge_basis_matches_jax(pair):
    jp, tp = pair
    got = ttypes.bal_gauge_basis(tp)["VERTEX_CAMERA_BAL"]
    want = np.asarray(jtypes.bal_gauge_basis(jp)["VERTEX_CAMERA_BAL"])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    Q = got.reshape(-1, 7)
    np.testing.assert_allclose(Q.T @ Q, np.eye(7), atol=1e-12)
    # the directions are null directions of the Jacobian (orbit tangents)
    cams = tp.estimates["VERTEX_CAMERA_BAL"].numpy()
    pts = tp.estimates["VERTEX_TRACKXYZ"].numpy()
    Gc, Gp = ttypes.bal_gauge_directions(cams, pts)
    Gc_j, Gp_j = jtypes.bal_gauge_directions(cams, pts)
    np.testing.assert_allclose(Gc, Gc_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(Gp, Gp_j, rtol=1e-12, atol=1e-12)
    lin = tp.linearize_fn(tp.data, tp.estimates)
    vidx = tp.data.edges["EDGE_OBSERVATION_BAL"].vidx.numpy()
    Jc, Jl = (J.numpy() for J in lin.jacs["EDGE_OBSERVATION_BAL"])
    JG = (np.einsum("erd,edk->erk", Jc, Gc[vidx[:, 0]])
          + np.einsum("erd,edk->erk", Jl, Gp[vidx[:, 1]]))
    assert np.abs(JG).max() <= 1e-6 * np.abs(Jc).max()


def _parsed(text):
    return tuple(np.asarray(a) for a in tbal._parse(text))


def test_make_synthetic_bal_matches_jax():
    kw = dict(n_cameras=6, n_points=50, n_obs_per_point=4, seed=3)
    got, want = _parsed(tbal.make_synthetic_bal(**kw)), \
        _parsed(jbal.make_synthetic_bal(**kw))
    for a, b in zip(got, want, strict=True):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    assert got[0].shape == (200, 4) and got[1].shape == (6, 9)


def test_make_stress_bal_matches_jax():
    kw = dict(n_cameras=6, n_points=50, mean_obs_per_point=4, seed=4)
    got, want = _parsed(tbal.make_stress_bal(**kw)), \
        _parsed(jbal.make_stress_bal(**kw))
    for a, b in zip(got, want, strict=True):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_cached_text_is_the_committed_file(text):
    assert tbal.synthetic_bal_cached(n_cameras=20, n_points=800,
                                     n_obs_per_point=5) == text


def test_stress_cached_text_is_the_committed_file():
    """The default stress key names the committed file (120 cameras,
    30000 points, 179,961 observations)."""
    obs, cams, pts = tbal._parse(tbal.stress_bal_cached())
    assert (len(cams), len(pts), len(obs)) == (120, 30000, 179961)


def test_parse_rejects_short_file():
    with pytest.raises(ValueError, match="needs"):
        tbal.load_bal_problem(io.StringIO("2 1 3\n0 0 1.0 2.0\n"),
                              device="cpu")

