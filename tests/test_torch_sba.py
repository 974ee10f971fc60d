"""Port parity: ``types/sba.py``, ``create_ba_scene`` and the sba ``.g2o``
lines against the JAX package, float64 on the CPU.

* every sba edge type's residuals and Jacobians on one random graph with
  both camera vertex types, an intrinsics vertex, the shared
  ``CameraParameters`` and per-edge ORB-SLAM intrinsics: rtol 1e-12 (the
  port's Problem is built from the JAX Problem's arrays);
* the round-5 regressions of the reference's sba types: the intrinsics
  vertex has 4 degrees of freedom (a nonsingular block), ``EDGE_CAM`` flips
  its quaternion to w >= 0 past 180 degrees, ``EDGE_SCALE`` has a finite
  Jacobian at zero distance;
* ``create_ba_scene`` equal to the JAX package's bit for bit;
* the sba ``.g2o`` text (``PARAMS_CAMERAPARAMETERS``) loads and saves to the
  same text in both packages.
"""

import numpy as np
import pytest
import torch

import g2o_tpu.types  # noqa: F401
import g2o_tpu_torch  # noqa: F401
from g2o_tpu.core.graph import Graph as JGraph
from g2o_tpu.io import g2o_format as jio
from g2o_tpu.sim.generators import create_ba_scene as j_create_ba_scene
from g2o_tpu.types import sba as jsba
from g2o_tpu_torch.core.graph import Graph as TGraph
from g2o_tpu_torch.io import g2o_format as tio
from g2o_tpu_torch.sim.generators import create_ba_scene as t_create_ba_scene
from g2o_tpu_torch.types import sba as tsba
from test_torch_problem import port_problem

EDGE_NAMES = ["EDGE_PROJECT_XYZ2UV:EXPMAP", "EDGE_PROJECT_XYZ2UVU:EXPMAP",
              "EDGE_PROJECT_P2MC", "EDGE_PROJECT_P2SC", "EDGE_CAM",
              "EDGE_SCALE", "EDGE_PROJECT_P2MC_INTRINSICS",
              "EDGE_SE3_PROJECT_XYZ:EXPMAP",
              "EDGE_STEREO_SE3_PROJECT_XYZ:EXPMAP",
              "EDGE_SE3_PROJECT_XYZONLYPOSE:EXPMAP",
              "EDGE_STEREO_SE3_PROJECT_XYZONLYPOSE:EXPMAP",
              "EDGE_PROJECT_PSI2UV:EXPMAP", "EDGE_SE3:EXPMAP"]
VERTEX_NAMES = ["VERTEX_SE3:EXPMAP", "VERTEX_CAM", "VERTEX_INTRINSICS"]


def _quat(rng, scale):
    q = np.concatenate([rng.normal(scale=scale, size=3), [1.0]])
    return q / np.linalg.norm(q)


def _random_graph(G, t, seed=4):
    """A graph with every sba edge type: 6 expmap cameras (0 fixed), 5 SBA
    cameras (0 fixed), one intrinsics vertex, 8 points in front of the
    cameras, the shared camera parameters (id 0) and ORB-SLAM mono (1) and
    stereo (2) intrinsics; the same numbers for either package."""
    rng = np.random.default_rng(seed)
    g = G()
    g.add_parameter(t.CAM_PARAM_ID, [500.0, 320.0, 240.0, 0.12])
    g.add_parameter(1, [510.0, 495.0, 318.0, 242.0])
    g.add_parameter(2, [510.0, 495.0, 318.0, 242.0, 40.0])
    for i in range(6):
        g.add_vertex(i, t.VertexSE3Expmap, np.concatenate(
            [rng.normal(scale=0.3, size=3), _quat(rng, 0.1)]), fixed=(i == 0))
    for i in range(5):
        g.add_vertex(10 + i, t.VertexCam, np.concatenate(
            [rng.normal(scale=0.3, size=3), _quat(rng, 0.1),
             [505.0, 498.0, 321.0, 239.0, 0.1]]), fixed=(i == 0))
    g.add_vertex(20, t.VertexIntrinsics, [490.0, 505.0, 315.0, 245.0, 0.1])
    for j in range(8):
        g.add_vertex(30 + j, t.VertexPointXYZ,
                     [rng.uniform(-1, 1), rng.uniform(-1, 1),
                      rng.uniform(4, 8)])
    # inverse-depth points: (u, v, rho) in the anchor frame
    for j in range(4):
        g.add_vertex(40 + j, t.VertexPointXYZ,
                     [rng.uniform(-0.2, 0.2), rng.uniform(-0.2, 0.2),
                      rng.uniform(0.1, 0.3)])

    def info(r):
        A = rng.normal(size=(r, r))
        return A @ A.T + r * np.eye(r)

    def uv(d=2):
        return np.array([320.0, 240.0, 300.0][:d]) + rng.normal(
            scale=20.0, size=d)

    for j in range(8):
        pt, c, sc = 30 + j, j % 6, 10 + j % 5
        g.add_edge(t.EdgeProjectXYZ2UV, [pt, c], uv(), info(2),
                   param_id=t.CAM_PARAM_ID)
        g.add_edge(t.EdgeProjectXYZ2UVU, [pt, (c + 1) % 6], uv(3), info(3),
                   param_id=t.CAM_PARAM_ID)
        g.add_edge(t.EdgeProjectP2MC, [pt, sc], uv(), info(2))
        g.add_edge(t.EdgeProjectP2SC, [pt, 10 + (j + 2) % 5], uv(3), info(3))
        g.add_edge(t.EdgeProjectP2MCIntrinsics, [pt, sc, 20], uv(), info(2))
        g.add_edge(t.EdgeSE3ProjectXYZ, [pt, (c + 2) % 6], uv(), info(2),
                   param_id=1)
        g.add_edge(t.EdgeStereoSE3ProjectXYZ, [pt, (c + 3) % 6], uv(3),
                   info(3), param_id=2)
    for i in range(6):
        Xw = [rng.uniform(-1, 1), rng.uniform(-1, 1), rng.uniform(4, 8)]
        g.add_edge(t.EdgeSE3ProjectXYZOnlyPose, [i], np.concatenate(
            [uv(), Xw]), info(2), param_id=1)
        g.add_edge(t.EdgeStereoSE3ProjectXYZOnlyPose, [i], np.concatenate(
            [uv(3), Xw]), info(3), param_id=2)
        g.add_edge(t.EdgeSE3Expmap, [i, (i + 1) % 6], np.concatenate(
            [rng.normal(scale=0.2, size=3), _quat(rng, 0.2)]), info(6))
    for j in range(4):
        # the observer is the anchor on the first edge of each point
        for obs in (j + 1, j + 2):
            g.add_edge(t.EdgeProjectPSI2UV, [40 + j, obs % 6, j + 1], uv(),
                       info(2), param_id=t.CAM_PARAM_ID)
    for i in range(4):
        g.add_edge(t.EdgeSBACam, [10 + i, 11 + i], np.concatenate(
            [rng.normal(scale=0.2, size=3), _quat(rng, 0.2)]), info(6))
        g.add_edge(t.EdgeSBAScale, [10 + i, 10 + (i + 2) % 5],
                   [rng.uniform(0.2, 0.6)], info(1))
    return g


def _close(a, b, rtol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def lin_pair():
    jg = _random_graph(JGraph, jsba)
    jg.set_robust_kernel("Cauchy", 3.0)
    jp = jg.compile()
    tp = port_problem(jp)
    return (jp, tp, jp.linearize_jit(jp.data, jp.estimates),
            tp.linearize_fn(tp.data, tp.estimates))


def test_every_sba_type_is_registered():
    reg = g2o_tpu_torch.core.types.REGISTRY
    for name in EDGE_NAMES:
        assert reg.edge_types[name] is reg.edge_for_tag(name)
    for name in VERTEX_NAMES:
        assert reg.vertex_types[name] is reg.vertex_for_tag(name)
    assert reg.edge_for_tag("EDGE_PROJECT_XYZ2UV") is tsba.EdgeProjectXYZ2UV
    assert len(EDGE_NAMES) + len(VERTEX_NAMES) == 16


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
    tg = _random_graph(TGraph, tsba)
    tg.set_robust_kernel("Cauchy", 3.0)
    own = tg.compile(dtype=torch.float64, device="cpu")
    _close(float(own.chi2_fn(own.data, own.estimates)[0]),
           float(jl.chi2_robust))


@pytest.mark.parametrize("name", VERTEX_NAMES)
def test_vertex_oplus_matches(name):
    rng = np.random.default_rng(7)
    jvt = jsba.VertexSE3Expmap if name == VERTEX_NAMES[0] else \
        jsba.VertexCam if name == "VERTEX_CAM" else jsba.VertexIntrinsics
    tvt = g2o_tpu_torch.core.types.REGISTRY.vertex_types[name]
    assert (tvt.rep_dim, tvt.tangent_dim) == (jvt.rep_dim, jvt.tangent_dim)
    x = rng.normal(size=(9, tvt.rep_dim))
    if name != "VERTEX_INTRINSICS":
        x[:, 3:7] /= np.linalg.norm(x[:, 3:7], axis=1, keepdims=True)
    d = rng.normal(scale=0.3, size=(9, tvt.tangent_dim))
    want = np.stack([np.asarray(jvt.oplus(x[i], d[i])) for i in range(9)])
    _close(tvt.oplus(torch.tensor(x), torch.tensor(d)).numpy(), want)


def test_intrinsics_vertex_has_four_degrees_of_freedom(lin_pair):
    """The baseline is a constant payload: the intrinsics block of H is
    4x4 and nonsingular, as in the JAX package."""
    jp, tp, jl, tl = lin_pair
    assert tp.vertex_types["VERTEX_INTRINSICS"].tangent_dim == 4
    J = tl.jacs["EDGE_PROJECT_P2MC_INTRINSICS"][2]
    assert J.shape[1:] == (2, 4)
    H = tl.diag["VERTEX_INTRINSICS"][0].numpy()
    assert H.shape == (4, 4) and np.linalg.matrix_rank(H) == 4
    _close(H, jl.diag["VERTEX_INTRINSICS"][0])


def _two_cam_graph(G, t, c2, meas, etype, info_dim):
    g = G()
    cam = [505.0, 498.0, 321.0, 239.0, 0.1]
    g.add_vertex(0, t.VertexCam, [0, 0, 0, 0, 0, 0, 1.0] + cam)
    g.add_vertex(1, t.VertexCam, list(c2) + cam)
    g.add_edge(etype, [0, 1], meas, np.eye(info_dim))
    return g


def test_edge_cam_flips_to_positive_w_past_180_degrees():
    """A 200-degree relative rotation about z: the composed quaternion has
    w < 0, and the error is the vec part of its w >= 0 sign."""
    half = np.deg2rad(200.0) / 2
    c2 = [0.3, -0.2, 0.1, 0.0, 0.0, np.sin(half), np.cos(half)]
    meas = [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0]
    pair = []
    for G, t in ((JGraph, jsba), (TGraph, tsba)):
        g = _two_cam_graph(G, t, c2, meas, t.EdgeSBACam, 6)
        kw = {} if G is JGraph else dict(dtype=torch.float64, device="cpu")
        p = g.compile(**kw)
        lin = (p.linearize_jit if G is JGraph else p.linearize_fn)(
            p.data, p.estimates)
        pair.append((np.asarray(lin.errors["EDGE_CAM"]),
                     [np.asarray(J) for J in lin.jacs["EDGE_CAM"]]))
    (je, jJ), (te, tJ) = pair
    assert np.cos(half) < 0
    _close(te[0, 3:6], [0.0, 0.0, -np.sin(half)])
    _close(te, je)
    for a, b in zip(tJ, jJ):
        _close(a, b)


def test_edge_scale_jacobian_is_finite_at_zero_distance():
    """Two camera centres at one point: the double-where guard keeps the
    reverse-mode Jacobian finite (zero), as in the JAX package."""
    c2 = [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0]
    pair = []
    for G, t in ((JGraph, jsba), (TGraph, tsba)):
        g = _two_cam_graph(G, t, c2, [0.5], t.EdgeSBAScale, 1)
        kw = {} if G is JGraph else dict(dtype=torch.float64, device="cpu")
        p = g.compile(**kw)
        lin = (p.linearize_jit if G is JGraph else p.linearize_fn)(
            p.data, p.estimates)
        pair.append([np.asarray(J) for J in lin.jacs["EDGE_SCALE"]]
                    + [np.asarray(lin.errors["EDGE_SCALE"])])
    for a, b in zip(*pair):
        assert np.isfinite(a).all()
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pair[1][0], np.zeros((1, 1, 6)))


# --------------------------------------------------------------------------- #
# create_ba_scene
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kw", [
    dict(n_cameras=15, n_points=300, seed=0),
    dict(n_cameras=8, n_points=60, seed=3, pixel_noise=0.5, point_noise=0.3),
    dict(n_cameras=8, n_points=50, seed=5, outlier_ratio=0.2)])
def test_create_ba_scene_identical_to_jax(kw):
    (jg, jt), (tg, tt) = j_create_ba_scene(**kw), t_create_ba_scene(**kw)
    assert list(jt) == list(tt)
    for vid in jt:
        np.testing.assert_array_equal(tt[vid], jt[vid])
    jv, tv = jg.vertices(), tg.vertices()
    assert sorted(jv) == sorted(tv)
    for vid in jv:
        a, b = tv[vid], jv[vid]
        assert a.vtype.name == b.vtype.name
        assert (a.fixed, a.marginalized) == (b.fixed, b.marginalized)
        np.testing.assert_array_equal(a.estimate, b.estimate)
    assert tg.num_edges == jg.num_edges > 2 * len(jt)
    for a, b in zip(tg.edges(), jg.edges()):
        assert (a.etype.name, a.vids, a.param_id) == (b.etype.name, b.vids,
                                                      b.param_id)
        np.testing.assert_array_equal(a.measurement, b.measurement)
        np.testing.assert_array_equal(a.information, b.information)
    np.testing.assert_array_equal(tg.parameter(0), jg.parameter(0))


# --------------------------------------------------------------------------- #
# .g2o load / save
# --------------------------------------------------------------------------- #

def test_sba_text_round_trips_as_in_jax():
    """Every sba tag with ``PARAMS_CAMERAPARAMETERS``, written by the JAX
    package: both loaders read it, both writers give the same text, and the
    port's compile of its read gives the JAX package's chi2."""
    jg = _random_graph(JGraph, jsba)
    text = jio.dumps(jg)
    assert "PARAMS_CAMERAPARAMETERS 0 500 320 240 0.12" in text
    for tag in EDGE_NAMES + VERTEX_NAMES:
        assert f"\n{tag} " in text, tag
    jg2, tg = jio.loads(text), tio.loads(text)
    assert tio.dumps(tg) == jio.dumps(jg2) == text
    for a, b in zip(tg.edges(), jg2.edges()):
        assert a.etype.name == b.etype.name and a.vids == b.vids
        assert a.param_id == b.param_id
        np.testing.assert_array_equal(a.measurement, b.measurement)
    p = tg.compile(dtype=torch.float64, device="cpu")
    jp = jg2.compile()
    _close(float(p.chi2_fn(p.data, p.estimates)[0]),
           float(jp.chi2_jit(jp.data, jp.estimates)[0]), rtol=1e-10)
