"""Port parity: ``types/slam2d_addons.py``, ``types/sclam2d.py``,
``types/icp.py`` and ``types/data.py`` against the JAX package, float64 on
the CPU.

* every edge type's residuals and Jacobians on one random graph (SE2 poses,
  points, segments, (θ, ρ) lines, a sensor-offset SE2 calibration vertex,
  a differential-drive calibration vertex, SE3 poses with GICP pairs):
  rtol 1e-10; b, the diagonal blocks and chi2: 1e-10;
* ``velocity_to_motion``'s straight-line branch (|vr - vl| < 1e-7): the
  value and a finite Jacobian equal to the JAX package's (1e-12);
* the NaN-guarded bearing edge (the JAX package's ``4198c9f``): a
  landmark on the pose origin gives a finite Jacobian, equal to the JAX
  package's;
* ``gicp_information`` / ``gicp_measurement``: 1e-12;
* ROBOTLASER1 payloads: parsed and written as the JAX package does, kept
  on their vertex through a load and a save, and dropped with the vertex
  (``4198c9f``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import g2o_tpu.types  # noqa: F401
import g2o_tpu_torch.types  # noqa: F401
from g2o_tpu.core.graph import Graph as JGraph
from g2o_tpu.io import g2o_format as jio
from g2o_tpu.types import data as jdata
from g2o_tpu.types import icp as jicp
from g2o_tpu.types import sclam2d as jsclam
from g2o_tpu.types import slam2d as jslam2d
from g2o_tpu.types import slam2d_addons as jadd2
from g2o_tpu.types import slam3d as jslam3d
from g2o_tpu_torch.core.graph import Graph as TGraph
from g2o_tpu_torch.io import g2o_format as tio
from g2o_tpu_torch.types import data as tdata
from g2o_tpu_torch.types import icp as ticp
from g2o_tpu_torch.types import sclam2d as tsclam
from g2o_tpu_torch.types import slam2d as tslam2d
from g2o_tpu_torch.types import slam2d_addons as tadd2
from g2o_tpu_torch.types import slam3d as tslam3d
from test_torch_problem import port_problem

RTOL = 1e-10        # residuals, Jacobians, b, chi2


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * max(np.abs(b).max(), 1e-300))


class _Types:
    """One package's type modules, by role."""

    def __init__(self, sl2, add2, scl, ic, sl3):
        self.sl2, self.add2, self.scl, self.icp, self.sl3 = (sl2, add2, scl,
                                                             ic, sl3)


J = _Types(jslam2d, jadd2, jsclam, jicp, jslam3d)
T = _Types(tslam2d, tadd2, tsclam, ticp, tslam3d)


def _random_graph(G, m, seed=9):
    """Every edge type of slam2d_addons, sclam2d and icp; the same numbers
    for either package."""
    rng = np.random.default_rng(seed)
    g = G()
    for i in range(8):
        g.add_vertex(i, m.sl2.VertexSE2, [i + rng.normal(scale=0.2),
                                          rng.normal(),
                                          rng.uniform(-np.pi, np.pi)],
                     fixed=(i == 0))
    for j in range(5):
        g.add_vertex(100 + j, m.sl2.VertexPointXY, rng.normal(size=2) * 3)
        g.add_vertex(200 + j, m.add2.VertexSegment2D,
                     rng.normal(size=4) * 3)
        g.add_vertex(300 + j, m.add2.VertexLine2D,
                     [rng.uniform(-np.pi, np.pi), rng.uniform(0, 4), -1, -1])
    g.add_vertex(400, m.sl2.VertexSE2, [0.1, -0.05, 0.2])
    g.add_vertex(401, m.scl.VertexOdomDifferentialParams, [1.02, 0.97, 0.52])
    for k in range(4):
        q = np.concatenate([0.2 * rng.normal(size=3), [1.0]])
        g.add_vertex(500 + k, m.sl3.VertexSE3, np.concatenate(
            [rng.normal(size=3), q / np.linalg.norm(q)]), fixed=(k == 0))

    def info(r):
        A = rng.normal(size=(r, r))
        return A @ A.T + r * np.eye(r)

    def ang():
        return rng.uniform(-np.pi, np.pi)

    for i in range(8):
        s, l, p = 200 + i % 5, 300 + i % 5, 100 + i % 5
        g.add_edge(m.add2.EdgeSE2Segment2D, [i, s], rng.normal(size=4),
                   info(4))
        g.add_edge(m.add2.EdgeSE2Segment2DLine, [i, s], [ang(), rng.normal()],
                   info(2))
        g.add_edge(m.add2.EdgeSE2Segment2DPointLine, [i, s],
                   [rng.normal(), rng.normal(), ang()], info(3))
        g.add_edge(m.add2.EdgeSE2Segment2DPointLine1, [i, s],
                   [rng.normal(), rng.normal(), ang()], info(3))
        g.add_edge(m.add2.EdgeSE2Line2D, [i, l], [ang(), rng.normal()],
                   info(2))
    for i in range(7):
        g.add_edge(m.scl.EdgeSE2SensorCalib, [i, i + 1, 400],
                   [rng.normal(), rng.normal(), ang()], info(3))
        vl = rng.uniform(0.5, 1.5)
        # every third edge drives straight (vr == vl)
        vr = vl if i % 3 == 0 else rng.uniform(0.5, 1.5)
        g.add_edge(m.scl.EdgeSE2OdomDifferentialCalib, [i, i + 1, 401],
                   [vl, vr, rng.uniform(0.5, 1.0)], info(3))
    for j in range(5):
        g.add_edge(m.add2.EdgeLine2D, [300 + j, 300 + (j + 1) % 5],
                   rng.normal(size=2), info(2))
        g.add_edge(m.add2.EdgeLine2DPointXY, [300 + j, 100 + j],
                   [rng.normal()], info(1))
    for k in range(3):
        for _ in range(3):
            n0, n1 = rng.normal(size=3), rng.normal(size=3)
            meas = m.icp.gicp_measurement(rng.normal(size=3), n0,
                                          rng.normal(size=3), n1)
            g.add_edge(m.icp.EdgeVVGicp, [500 + k, 501 + k], meas,
                       m.icp.gicp_information(n0, 1e-2, n1))
    return g


EDGE_NAMES = ["EDGE_SE2_SEGMENT2D", "EDGE_SE2_SEGMENT2D_LINE",
              "EDGE_SE2_SEGMENT2D_POINTLINE",
              "EDGE_SE2_SEGMENT2D_POINTLINE_P1", "EDGE_SE2_LINE2D",
              "EDGE_LINE2D", "EDGE_LINE2D_POINTXY", "EDGE_SE2_CALIB",
              "EDGE_SE2_ODOM_DIFFERENTIAL_CALIB", "EDGE_V_V_GICP"]


@pytest.fixture(scope="module")
def lin_pair():
    jg = _random_graph(JGraph, J)
    jg.set_robust_kernel("Huber", 2.0)
    jp = jg.compile()
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
    jp, tp, jl, tl = lin_pair
    _close(tl.b.numpy(), jl.b)
    for t in jp.vertex_types:
        _close(tl.diag[t].numpy(), jl.diag[t])
    _close(float(tl.chi2_robust), float(jl.chi2_robust))
    tg = _random_graph(TGraph, T)
    tg.set_robust_kernel("Huber", 2.0)
    own = tg.compile(dtype=torch.float64, device="cpu")
    _close(float(own.chi2_fn(own.data, own.estimates)[0]),
           float(jl.chi2_robust))


def test_velocity_to_motion_straight_branch_matches_jax():
    """vr == vl takes the straight-line branch; its value and its Jacobian
    (through the guarded arc branch) are finite and the JAX package's."""
    x = np.array([[0.8, 0.8, 0.5, 0.5], [0.8, 0.8 + 5e-8, 0.5, 0.5],
                  [0.8, 1.1, 0.5, 0.5], [-0.3, -0.3, 1.0, 0.4]])

    def f(mod):
        return lambda v: mod.velocity_to_motion(v[0], v[1], v[2], v[3])

    for row in x:
        want = np.asarray(f(jsclam)(jnp.asarray(row)))
        got = f(tsclam)(torch.tensor(row)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        Jj = np.asarray(jax.jacfwd(f(jsclam))(jnp.asarray(row)))
        Jt = torch.func.jacrev(f(tsclam))(torch.tensor(row)).numpy()
        assert np.isfinite(Jt).all()
        np.testing.assert_allclose(Jt, Jj, rtol=0, atol=1e-12)


def test_bearing_edge_finite_at_pose_origin_as_jax():
    """The bearing edge's double-``where`` guard (the JAX package's
    ``4198c9f``): with the landmark on the observing pose's origin the
    bearing's ``atan2(0, 0)`` would give a 0/0 derivative; both packages
    give the same finite Jacobian."""
    def graph(G, sl2):
        g = G()
        g.add_vertex(0, sl2.VertexSE2, [0.0, 0.0, 0.3])
        g.add_vertex(1, sl2.VertexPointXY, [0.0, 0.0])
        g.add_vertex(2, sl2.VertexPointXY, [2.0, 2.5])
        g.add_edge(sl2.EdgeSE2PointXYBearing, [0, 1], [0.2], [[4.0]])
        g.add_edge(sl2.EdgeSE2PointXYBearing, [0, 2], [0.2], [[4.0]])
        return g

    jp = graph(JGraph, jslam2d).compile()
    tp = port_problem(jp)
    jl = jp.linearize_jit(jp.data, jp.estimates)
    tl = tp.linearize_fn(tp.data, tp.estimates)
    name = "EDGE_BEARING_SE2_XY"
    _close(tl.errors[name].numpy(), jl.errors[name], rtol=1e-12)
    for Jt, Jj in zip(tl.jacs[name], jl.jacs[name]):
        assert np.isfinite(Jt.numpy()).all()
        np.testing.assert_allclose(Jt.numpy(), np.asarray(Jj), rtol=0,
                                   atol=1e-12)
    own = graph(TGraph, tslam2d).compile(dtype=torch.float64, device="cpu")
    lin = own.linearize_fn(own.data, own.estimates)
    assert all(np.isfinite(J.numpy()).all() for J in lin.jacs[name])
    # the linearization takes reverse mode here (r = 1), where torch's
    # atan2 gives 0 at (0, 0) by itself; forward mode gives 0/0 without
    # the guard
    x = torch.tensor([0.0, 0.0, 0.3], dtype=torch.float64)
    res = tslam2d.EdgeSE2PointXYBearing.residual
    Jf = torch.func.jacfwd(lambda l: res((x, l), torch.tensor([0.2]),
                                         None))(torch.zeros(2,
                                                            dtype=x.dtype))
    assert np.isfinite(Jf.numpy()).all()


def test_gicp_information_matches_jax():
    rng = np.random.default_rng(2)
    for n0 in (rng.normal(size=3), np.array([0.0, 1.0, 0.0]),
               np.array([0.0, -2.0, 0.0])):
        n1 = rng.normal(size=3)
        for args in ((n0,), (n0, 1e-2), (n0, 1e-3, n1), (n0, 1e-3, n1, 5e-2)):
            np.testing.assert_allclose(ticp.gicp_information(*args),
                                       jicp.gicp_information(*args),
                                       rtol=0, atol=1e-12)
    a = [rng.normal(size=3) for _ in range(4)]
    np.testing.assert_array_equal(ticp.gicp_measurement(*a),
                                  jicp.gicp_measurement(*a))


# --------------------------------------------------------------------------- #
# data payloads
# --------------------------------------------------------------------------- #

LASER = ("ROBOTLASER1 0 -1.5707963 3.1415927 0.017453293 81.9 0.01 0 "
         "5 1.5 2.25 81.9 3 4.125 0 0 1.5 2.5 0.3 1.4 2.4 0.25 0.1 -0.05 "
         "0.5 0.3 1234.5678 myhost 1234.6")


def test_robot_laser_parse_and_serialize_match_jax():
    tj, tt = jdata.RobotLaser.parse(LASER), tdata.RobotLaser.parse(LASER)
    for f in ("type", "first_beam_angle", "fov", "angular_step", "max_range",
              "accuracy", "remission_mode", "laser_tv", "laser_rv",
              "forward_safety_dist", "side_safety_dist", "turn_axis",
              "timestamp", "hostname", "logger_timestamp"):
        assert getattr(tt, f) == getattr(tj, f), f
    for f in ("ranges", "remissions", "laser_pose", "odom_pose"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(tj, f))
    assert tt.serialize() == tj.serialize()
    np.testing.assert_array_equal(tt.cartesian(), tj.cartesian())
    # without the optional timestamps and host name
    short = " ".join(LASER.split()[:-3])
    assert tdata.RobotLaser.parse(short).serialize() == \
        jdata.RobotLaser.parse(short).serialize()
    with pytest.raises(ValueError):
        tdata.RobotLaser.parse("RAWLASER1 0 1")


def test_payloads_ride_with_their_vertex():
    """Payload lines attach to the vertex defined before them (one before
    any vertex is dropped, as in the JAX package), come back on save, give
    typed views, and leave with their vertex."""
    text = "\n".join([
        "ROBOTLASER1 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0",
        "VERTEX_SE2 0 0 0 0", "FIX 0", LASER,
        "VERTEX_SE2 1 1 0 0", "RAWLASER1 1 2 3",
        "EDGE_SE2 0 1 1 0 0 1 0 0 1 0 1",
    ]) + "\n"
    jg, tg = jio.loads(text), tio.loads(text)
    for vid in (0, 1):
        assert tg.vertex_data(vid) == jg.vertex_data(vid)
    assert tg.vertex_data(0) == [LASER]
    assert tio.dumps(tg) == jio.dumps(jg)
    views = tdata.parse_vertex_payloads(tg, 0)
    assert len(views) == 1 and views[0].serialize() == \
        jdata.parse_vertex_payloads(jg, 0)[0].serialize()
    assert tdata.parse_vertex_payloads(tg, 1) == []
    assert tg.remove_vertex(0) and jg.remove_vertex(0)
    tg.add_vertex(0, "VERTEX_SE2", [0, 0, 0])
    assert tg.vertex_data(0) == []
    assert tg.num_edges == 0
    with pytest.raises(ValueError):
        tg.add_vertex_data(7, LASER)
