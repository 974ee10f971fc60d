"""Port parity: the seven slam3d edges this slice adds and
``types/slam3d_addons.py``, against the JAX package, float64 on the CPU.

* every edge type's residuals and Jacobians on one random graph (poses,
  points in front of a camera, Plücker lines, planes, a calibration
  vertex, ``VERTEX3`` poses, four parameter blocks): rtol 1e-10; b, the
  diagonal blocks and chi2 over the whole graph: 1e-10;
* the plane and line operations on random inputs: 1e-12;
* zero norms: a line through the origin seen from a pose at the origin
  gives NaN derivatives in the JAX package (``jnp.linalg.norm`` at 0);
  the port computes its norms the same way and gives NaN at the same
  entries (``torch.linalg.vector_norm`` would give 0); a vertical plane
  normal gives finite, equal Jacobians in both;
* the EDGE3 information basis (the JAX package's ``69e0a16``):
  ``info_from_io`` / ``info_to_io`` against the JAX package (1e-12), and a
  round trip through a file in both directions (the port's text equal to
  the JAX package's byte for byte);
* the deprecated tag spellings load to the same graph.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import g2o_tpu.types  # noqa: F401
import g2o_tpu_torch.types  # noqa: F401
from g2o_tpu.core.graph import Graph as JGraph
from g2o_tpu.io import g2o_format as jio
from g2o_tpu.types import slam3d as jslam3d
from g2o_tpu.types import slam3d_addons as jadd
from g2o_tpu_torch.core.graph import Graph as TGraph
from g2o_tpu_torch.io import g2o_format as tio
from g2o_tpu_torch.types import slam3d as tslam3d
from g2o_tpu_torch.types import slam3d_addons as tadd
from test_torch_problem import port_problem

RTOL = 1e-10        # residuals, Jacobians, b, chi2


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * max(np.abs(b).max(), 1e-300))


def _quat(rng, scale=1.0):
    q = np.concatenate([scale * rng.normal(size=3), [1.0]])
    return q / np.linalg.norm(q)


def _se3(rng, tscale=1.0, rscale=0.3):
    return np.concatenate([tscale * rng.normal(size=3), _quat(rng, rscale)])


def _line(rng):
    d = rng.normal(size=3)
    d /= np.linalg.norm(d)
    return np.concatenate([np.cross(rng.normal(size=3) * 2, d), d])


def _plane(rng):
    n = rng.normal(size=3)
    return np.concatenate([n / np.linalg.norm(n), [rng.uniform(-4, 4)]])


def _random_graph(G, sl3, add, seed=5):
    """Every edge type of this slice's slam3d and slam3d_addons; the same
    numbers for either package."""
    rng = np.random.default_rng(seed)
    g = G()
    for i in range(8):
        g.add_vertex(i, sl3.VertexSE3, _se3(rng), fixed=(i == 0))
    for j in range(10):
        g.add_vertex(100 + j, sl3.VertexPointXYZ,
                     np.array([0.0, 0.0, 5.0]) + rng.normal(size=3))
    for k in range(4):
        g.add_vertex(200 + k, add.VertexLine3D, _line(rng))
    for k in range(3):
        g.add_vertex(300 + k, add.VertexPlane, _plane(rng))
    g.add_vertex(400, sl3.VertexSE3, _se3(rng, 0.1, 0.05))   # calibration
    for k in range(4):
        g.add_vertex(500 + k, add.VertexSE3Euler, _se3(rng, 1.0, 0.4),
                     fixed=(k == 0))
    g.add_parameter(0, _se3(rng, 0.1, 0.05))
    g.add_parameter(1, _se3(rng, 0.1, 0.05))
    g.add_parameter(2, _se3(rng, 0.1, 0.05))
    g.add_parameter(3, np.concatenate([_se3(rng, 0.05, 0.02),
                                       [300.0, 310.0, 160.0, 120.0]]))

    def info(r):
        A = rng.normal(size=(r, r))
        return A @ A.T + r * np.eye(r)

    for i in range(7):
        g.add_edge(sl3.EdgeSE3Offset, [i, (i + 3) % 8], _se3(rng), info(6),
                   param_id=(1, 2))
        g.add_edge(add.EdgeSE3Calib, [i, i + 1, 400], _se3(rng), info(6))
    for i in range(8):
        j, k = 100 + i % 10, 100 + (i + 3) % 10
        g.add_edge(sl3.EdgeSE3PointXYZ, [i, j], rng.normal(size=3), info(3),
                   param_id=0)
        uvz = np.array([160.0, 120.0, 5.0]) + rng.normal(size=3)
        g.add_edge(sl3.EdgeSE3PointXYZDepth, [i, k], uvz, info(3),
                   param_id=3)
        g.add_edge(sl3.EdgeSE3PointXYZDisparity, [i, k],
                   uvz / np.array([1.0, 1.0, 25.0]), info(3), param_id=3)
        g.add_edge(sl3.make_edge_se3_lots_of_xyz(3),
                   [i, j, k, 100 + (i + 6) % 10], rng.normal(size=9),
                   info(9))
        g.add_edge(add.EdgeSE3Line3D, [i, 200 + i % 4], _line(rng), info(4))
        g.add_edge(add.EdgeSE3PlaneCalib, [i, 300 + i % 3, 400], _plane(rng),
                   info(3))
    for j in range(10):
        g.add_edge(sl3.EdgePointXYZ, [100 + j, 100 + (j + 1) % 10],
                   rng.normal(size=3), info(3))
        g.add_edge(sl3.EdgeXYZPrior, [100 + j], rng.normal(size=3), info(3))
    g.add_edge(add.EdgePlane, [300, 301], 0.1 * rng.normal(size=4), info(4))
    g.add_edge(add.EdgePlane, [301, 302], 0.1 * rng.normal(size=4), info(4))
    for k in range(3):
        g.add_edge(add.EdgeSE3Euler, [500 + k, 501 + k], _se3(rng), info(6))
    return g


EDGE_NAMES = ["EDGE_SE3_TRACKXYZ", "EDGE_POINTXYZ", "EDGE_POINTXYZ_PRIOR",
              "EDGE_SE3_OFFSET", "EDGE_PROJECT_DEPTH",
              "EDGE_PROJECT_DISPARITY", "EDGE_SE3_LOTSOF_XYZ_3",
              "EDGE_SE3_LINE3D", "EDGE_PLANE", "EDGE_SE3_PLANE_CALIB",
              "EDGE_SE3_CALIB", "EDGE3"]


@pytest.fixture(scope="module")
def lin_pair():
    jg = _random_graph(JGraph, jslam3d, jadd)
    jg.set_robust_kernel("Huber", 2.0)
    jp = jg.compile()
    tslam3d.make_edge_se3_lots_of_xyz(3)     # registers the port's type
    tp = port_problem(jp)
    return (jp, tp, jp.linearize_jit(jp.data, jp.estimates),
            tp.linearize_fn(tp.data, tp.estimates))


@pytest.mark.parametrize("name", EDGE_NAMES)
def test_edge_residuals_and_jacobians_match(lin_pair, name):
    jp, tp, jl, tl = lin_pair
    assert name in jp.edge_types and name in tp.edge_types
    _close(tl.errors[name].numpy(), jl.errors[name])
    _close(tl.weights[name].numpy(), jl.weights[name])
    assert len(tl.jacs[name]) == len(jl.jacs[name])
    for Jt, Jj in zip(tl.jacs[name], jl.jacs[name]):
        assert np.isfinite(Jt.numpy()).all()
        _close(Jt.numpy(), Jj)


def test_whole_linearization_matches(lin_pair):
    """b, the diagonal blocks and chi2 over every type, and the port's own
    compile of its own graph to the same chi2."""
    jp, tp, jl, tl = lin_pair
    _close(tl.b.numpy(), jl.b)
    for t in jp.vertex_types:
        _close(tl.diag[t].numpy(), jl.diag[t])
    _close(float(tl.chi2_robust), float(jl.chi2_robust))
    tg = _random_graph(TGraph, tslam3d, tadd)
    tg.set_robust_kernel("Huber", 2.0)
    own = tg.compile(dtype=torch.float64, device="cpu")
    _close(float(own.chi2_fn(own.data, own.estimates)[0]),
           float(jl.chi2_robust))


# --------------------------------------------------------------------------- #
# plane and line operations
# --------------------------------------------------------------------------- #

def _batch(rng, f, n=24):
    return np.stack([f(rng) for _ in range(n)])


OPS = {
    "plane_oplus": lambda m, P, Q, L, M, X, d: m.plane_oplus(P, d[:, :3]),
    "plane_ominus": lambda m, P, Q, L, M, X, d: m.plane_ominus(P, Q),
    "plane_transform": lambda m, P, Q, L, M, X, d: m.plane_transform(X, P),
    "line3d_oplus": lambda m, P, Q, L, M, X, d: m.line3d_oplus(L, d),
    "line3d_ominus": lambda m, P, Q, L, M, X, d: m.line3d_ominus(L, M),
    "line3d_transform": lambda m, P, Q, L, M, X, d: m.line3d_transform(X, L),
}


@pytest.mark.parametrize("op", list(OPS))
def test_plane_and_line_ops_match_jax(op):
    rng = np.random.default_rng(11)
    args = (_batch(rng, _plane), _batch(rng, _plane), _batch(rng, _line),
            _batch(rng, _line), _batch(rng, _se3),
            0.3 * rng.normal(size=(24, 4)))
    want = np.asarray(OPS[op](jadd, *map(jnp.asarray, args)))
    got = OPS[op](tadd, *map(torch.tensor, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def _one_edge_jacobians(G, sl3, add, line, plane):
    """One EDGE_SE3_LINE3D on ``line`` and one EDGE_SE3_PLANE_CALIB on
    ``plane`` (both states and measurements), seen from the origin."""
    g = G()
    g.add_vertex(0, sl3.VertexSE3, [0, 0, 0, 0, 0, 0, 1.0])
    g.add_vertex(1, add.VertexLine3D, line)
    g.add_vertex(2, add.VertexPlane, plane)
    g.add_vertex(3, sl3.VertexSE3, [0, 0, 0, 0, 0, 0, 1.0], fixed=True)
    g.add_edge(add.EdgeSE3Line3D, [0, 1], line, np.eye(4))
    g.add_edge(add.EdgeSE3PlaneCalib, [0, 2, 3], plane, np.eye(3))
    return g


def test_zero_norms_give_the_jax_packages_nan_pattern():
    """A line through the origin (w = 0) seen from the origin: the JAX
    package's Jacobians hold NaN (the derivative of ``jnp.linalg.norm`` at
    a zero vector); the port's hold NaN at the same entries and agree
    everywhere else.  A vertical plane normal: finite in both."""
    line = np.array([0.0, 0.0, 0.0, 0.0, 0.6, 0.8])
    plane = np.array([0.0, 0.0, 1.0, 2.0])
    jp = _one_edge_jacobians(JGraph, jslam3d, jadd, line, plane).compile()
    tp = port_problem(jp)
    jl = jp.linearize_jit(jp.data, jp.estimates)
    tl = tp.linearize_fn(tp.data, tp.estimates)
    nans = {}
    for name in ("EDGE_SE3_LINE3D", "EDGE_SE3_PLANE_CALIB"):
        nans[name] = 0
        for Jt, Jj in zip(tl.jacs[name], jl.jacs[name]):
            Jt, Jj = Jt.numpy(), np.asarray(Jj)
            np.testing.assert_array_equal(np.isnan(Jt), np.isnan(Jj))
            nans[name] += int(np.isnan(Jj).sum())
            ok = ~np.isnan(Jj)
            np.testing.assert_allclose(Jt[ok], Jj[ok], rtol=0, atol=1e-12)
    assert nans == {"EDGE_SE3_LINE3D": 40, "EDGE_SE3_PLANE_CALIB": 0}


# --------------------------------------------------------------------------- #
# VERTEX3 / EDGE3: the information basis regression
# --------------------------------------------------------------------------- #

def test_edge3_information_basis_matches_jax():
    """``info_from_io`` / ``info_to_io`` (the central-difference Jacobian
    of the Euler map at the measurement) against the JAX package, and the
    two are each other's inverse."""
    rng = np.random.default_rng(3)
    for _ in range(5):
        m = _se3(rng, 1.0, 0.6)
        A = rng.normal(size=(6, 6))
        info = A @ A.T + 6 * np.eye(6)
        got = tadd.EdgeSE3Euler.info_from_io(info, m)
        want = jadd.EdgeSE3Euler.info_from_io(info, m)
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())
        back = tadd.EdgeSE3Euler.info_to_io(got, m)
        np.testing.assert_allclose(back, jadd.EdgeSE3Euler.info_to_io(
            want, m), rtol=1e-12, atol=1e-12 * np.abs(info).max())
        np.testing.assert_allclose(back, info, rtol=1e-8,
                                   atol=1e-8 * np.abs(info).max())
        np.testing.assert_allclose(tadd.qt_to_et(m), jadd.qt_to_et(m),
                                   rtol=0, atol=1e-15)
        e = tadd.qt_to_et(m)
        np.testing.assert_allclose(tadd.et_to_qt(e), jadd.et_to_qt(e),
                                   rtol=0, atol=1e-15)


def test_edge3_text_round_trips_through_a_file(tmp_path):
    """VERTEX3 / EDGE3 lines carry [t, roll, pitch, yaw] and the Euler
    information: the JAX package's file loads in the port to the same
    states, measurements and (error-space) information; the port's file
    is the JAX package's byte for byte and loads back in the JAX
    package."""
    jg = _random_graph(JGraph, jslam3d, jadd)
    path = tmp_path / "edge3.g2o"
    jio.save(jg, str(path))
    text = path.read_text()
    assert "VERTEX3 501" in text and "EDGE3 500 501" in text
    tg, jg2 = tio.load(str(path)), jio.load(str(path))
    for vid, rec in jg2.vertices().items():
        np.testing.assert_allclose(tg.vertex(vid).estimate, rec.estimate,
                                   rtol=0, atol=1e-15)
    for a, b in zip(tg.edges(), jg2.edges(), strict=True):
        assert a.etype.name == b.etype.name and a.vids == b.vids
        np.testing.assert_allclose(a.measurement, b.measurement, rtol=0,
                                   atol=1e-15)
        _close(a.information, b.information, rtol=1e-12)
    out = tmp_path / "port.g2o"
    tio.save(tg, str(out))
    assert out.read_text() == jio.dumps(jg2)
    back = jio.load(str(out))
    for a, b in zip(back.edges(), jg2.edges(), strict=True):
        _close(a.information, b.information, rtol=1e-9)


def test_deprecated_tags_load_as_in_jax():
    """The deprecated slam3d library's spellings (``DEPRECATED_*`` vertex,
    edge and parameter tags) load to the current types in both
    packages."""
    def eye(r):                     # the upper triangle of I_r
        return " ".join("1" if j == i else "0"
                        for i in range(r) for j in range(i, r))

    text = "\n".join([
        "DEPRECATED_PARAMS_SE3OFFSET 0 0.1 0 0 0 0 0 1",
        "DEPRECATED_PARAMS_CAMERACALIB 1 0 0 0 0 0 0 1 300 300 160 120",
        "DEPRECATED_VERTEX_SE3:QUAT 0 0 0 0 0 0 0 1",
        "FIX 0",
        "DEPRECATED_VERTEX_SE3:QUAT 1 1 0 0 0 0 0.1 0.99498743710662",
        "DEPRECATED_VERTEX_TRACKXYZ 2 0.5 0.2 4",
        f"DEPRECATED_EDGE_SE3:QUAT 0 1 1 0 0 0 0 0 1 {eye(6)}",
        f"DEPRECATED_EDGE_SE3_TRACKXYZ 1 2 0 0.5 0.2 3 {eye(3)}",
        f"DEPRECATED_EDGE_PROJECT_DEPTH 0 2 1 170 130 4 {eye(3)}",
        f"DEPRECATED_EDGE_PROJECT_DISPARITY 0 2 1 170 130 0.25 {eye(3)}",
        f"DEPRECATED_EDGE_SE3_PRIOR 1 0 1 0 0 0 0 0 1 {eye(6)}",
        f"DEPRECATED_EDGE_SE3_OFFSET 0 1 0 0 1 0 0 0 0 0 1 {eye(6)}",
    ]) + "\n"
    jg, tg = jio.loads(text), tio.loads(text)
    assert [e.etype.name for e in tg.edges()] == \
        [e.etype.name for e in jg.edges()]
    assert tio.dumps(tg) == jio.dumps(jg)
    assert "DEPRECATED" not in tio.dumps(tg)
    assert tg.vertex(0).fixed
