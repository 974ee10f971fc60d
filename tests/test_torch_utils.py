"""Port parity of the host utilities: ``utils/metrics.py`` (Umeyama, ATE,
RPE), ``utils/properties.py``, ``utils/tictoc.py``, ``utils/debug_dump.py``
and the optimizer's ``write_debug`` hooks, ``io/export.py`` and
``io/viz.py``, against the JAX package on the same inputs (a numpy seed,
or the same graph text read by both packages).

Metrics agree to rtol 1e-12 (the same numpy arithmetic); the gnuplot,
graphviz and HTML files are byte for byte the JAX package's; a debug dump
holds the JAX package's keys, with values equal to rtol 1e-9 (float64, two
summation orders)."""

import glob

import numpy as np
import pytest

import g2o_tpu.types  # noqa: F401
import g2o_tpu_torch as tg2o
from g2o_tpu.core.graph import Graph as JGraph
from g2o_tpu.core.optimizer import LevenbergMarquardt as JLM
from g2o_tpu.core.optimizer import SparseOptimizer as JSparseOptimizer
from g2o_tpu.core.solvers import DenseSolver as JDense
from g2o_tpu.io import export as jexport
from g2o_tpu.io import viz as jviz
from g2o_tpu.io import g2o_format as jio
from g2o_tpu.types import slam2d as jslam2d
from g2o_tpu.utils import metrics as jmetrics
from g2o_tpu_torch.io import export as texport
from g2o_tpu_torch.io import g2o_format as tio
from g2o_tpu_torch.io import viz as tviz
from g2o_tpu_torch.sim.generators import create_manhattan as t_manhattan
from g2o_tpu_torch.sim.generators import create_sphere as t_sphere
from g2o_tpu_torch.types import slam2d as tslam2d
from g2o_tpu_torch.utils import PropertyMap, metrics as tmetrics, tictoc

RTOL = 1e-12


# --------------------------------------------------------------------------- #
# metrics
# --------------------------------------------------------------------------- #

def _rot_z(th):
    return np.array([[np.cos(th), -np.sin(th), 0],
                     [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])


def test_umeyama_recovers_transform():
    rng = np.random.default_rng(3)
    src = rng.normal(size=(50, 3))
    R_gt, t_gt = _rot_z(0.7), np.array([1.0, -2.0, 0.5])
    dst = (R_gt @ src.T).T + t_gt
    R, t, s = tmetrics.umeyama_alignment(src, dst)
    np.testing.assert_allclose(R, R_gt, atol=1e-10)
    np.testing.assert_allclose(t, t_gt, atol=1e-10)
    assert s == 1.0


@pytest.mark.parametrize("with_scale", [False, True])
def test_umeyama_matches_jax(with_scale):
    rng = np.random.default_rng(8)
    src = rng.normal(size=(40, 3))
    dst = 1.3 * (_rot_z(-0.4) @ src.T).T + rng.normal(size=3) \
        + 0.05 * rng.normal(size=(40, 3))
    for a, b in zip(tmetrics.umeyama_alignment(src, dst, with_scale),
                    jmetrics.umeyama_alignment(src, dst, with_scale)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-14)


def test_ate_aligned_zero():
    rng = np.random.default_rng(4)
    gt = rng.normal(size=(30, 3))
    est = (_rot_z(0.3) @ gt.T).T + [5, 5, 5]
    assert tmetrics.ate(est, gt) < 1e-10
    assert tmetrics.ate(est, gt, align=False) > 1.0


def test_ate_se2_trajectories():
    gt = np.array([[i, 0.0, 0.1] for i in range(10)])
    est = gt.copy()
    est[:, 1] += 0.1  # constant offset removed by alignment
    assert tmetrics.ate(est, gt) < 1e-10
    est[5, 0] += 1.0
    assert tmetrics.ate(est, gt) > 0.1


def test_rpe():
    gt = np.array([[i, 0.0, 0] for i in range(10)], dtype=float)
    est = gt * 1.1  # 10% drift per step
    assert tmetrics.rpe(est, gt) == pytest.approx(0.1, rel=1e-6)


@pytest.mark.parametrize("kind", ["se2", "se3", "points"])
def test_ate_rpe_match_jax(kind):
    rng = np.random.default_rng(21)
    n = 60
    if kind == "se2":
        gt = np.c_[np.cumsum(rng.normal(size=(n, 2)), 0),
                   rng.uniform(-3, 3, n)]
        est = gt + 0.05 * rng.normal(size=gt.shape)
    elif kind == "se3":
        q = rng.normal(size=(n, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        gt = np.c_[np.cumsum(rng.normal(size=(n, 3)), 0), q]
        est = gt.copy()
        est[:, :3] += 0.05 * rng.normal(size=(n, 3))
    else:
        gt = rng.normal(size=(n, 2))
        est = gt + 0.05 * rng.normal(size=gt.shape)
    for kw in ({}, {"align": False}, {"with_scale": True}):
        np.testing.assert_allclose(tmetrics.ate(est, gt, **kw),
                                   jmetrics.ate(est, gt, **kw), rtol=RTOL)
    for delta in (1, 3):
        np.testing.assert_allclose(tmetrics.rpe(est, gt, delta=delta),
                                   jmetrics.rpe(est, gt, delta=delta),
                                   rtol=RTOL)


# --------------------------------------------------------------------------- #
# properties, tictoc
# --------------------------------------------------------------------------- #

def test_property_map():
    pm = PropertyMap()
    pm.make_property("maxIterations", 10)
    pm.make_property("lambdaInit", 1e-5)
    assert pm.update_from_string("maxIterations=25,lambdaInit=0.5") == 2
    assert pm.get_value("maxIterations") == 25
    assert pm.get_value("lambdaInit") == 0.5
    assert str(pm) == "lambdaInit=0.5, maxIterations=25"
    assert pm.set_value("lambdaInit", "2") and pm.get_value("lambdaInit") == 2
    assert not pm.set_value("bogus", 1)
    with pytest.raises(KeyError):
        pm.update_from_string("bogus=1")
    with pytest.raises(ValueError):
        pm.update_from_string("noequals")


def test_tictoc(monkeypatch, capsys):
    monkeypatch.setenv("G2O_ENABLE_TICTOC", "1")
    tictoc.reset()
    with tictoc.tictoc("foo"):
        pass
    with tictoc.tictoc("foo"):
        pass
    s = tictoc.stats()
    assert s["foo"]["count"] == 2
    assert 0 <= s["foo"]["min"] <= s["foo"]["mean"] <= s["foo"]["max"]
    assert tictoc.toc("never_started") == 0.0
    tictoc.print_stats()
    assert "foo: count=2" in capsys.readouterr().err
    tictoc.reset()


def test_tictoc_disabled(monkeypatch):
    monkeypatch.delenv("G2O_ENABLE_TICTOC", raising=False)
    tictoc.reset()
    tictoc.tic("x")
    assert tictoc.toc("x") == 0.0
    assert tictoc.stats() == {}


# --------------------------------------------------------------------------- #
# debug dump
# --------------------------------------------------------------------------- #

def _converged_pair(graph_cls, se2):
    """An exactly-converged problem: chi2 == 0, so every LM trial has
    rho <= 0 and the step fails after max_trials."""
    g = graph_cls()
    g.add_vertex(0, se2.VertexSE2, np.zeros(3), fixed=True)
    g.add_vertex(1, se2.VertexSE2, np.array([1.0, 0.0, 0.0]))
    g.add_vertex(2, se2.VertexSE2, np.array([2.0, 0.5, 0.1]))
    g.add_edge(se2.EdgeSE2, [0, 1], np.array([1.0, 0.0, 0.0]), np.eye(3))
    g.add_edge(se2.EdgeSE2, [1, 2], np.array([1.0, 0.5, 0.1]), np.eye(3))
    return g


def _dump(tmp_path, sub, opt):
    opt.write_debug = str(tmp_path / sub)
    done = opt.optimize(3)
    dumps = glob.glob(str(tmp_path / sub / "g2o_tpu_debug_it*.npz"))
    return done, dumps


def test_failed_lm_step_dumps_jax_keys(tmp_path):
    jp = _converged_pair(JGraph, jslam2d).compile()
    tp = _converged_pair(tg2o.Graph, tslam2d).compile(device="cpu")
    jdone, jd = _dump(tmp_path, "jax", JSparseOptimizer(
        jp, algorithm=JLM(max_trials_after_failure=2), solver=JDense()))
    tdone, td = _dump(tmp_path, "torch", tg2o.SparseOptimizer(
        tp, algorithm=tg2o.LevenbergMarquardt(max_trials_after_failure=2),
        solver=tg2o.DenseSolver()))
    assert tdone == jdone < 3    # the failed step terminated the loop
    assert len(td) == len(jd) == 1
    assert td[0].endswith("g2o_tpu_debug_it0.npz")
    z, zj = (np.load(td[0], allow_pickle=False),
             np.load(jd[0], allow_pickle=False))
    assert sorted(z.files) == sorted(zj.files)
    assert float(z["lambda"]) > 0
    assert "b" in z and np.all(np.isfinite(z["b"]))
    hkeys = [k for k in z.files if k.startswith("H_diag_")]
    assert hkeys
    for k in z.files:
        if k == "reason":
            assert str(z[k]) == str(zj[k])
        else:
            assert z[k].shape == zj[k].shape, k
            np.testing.assert_allclose(z[k], zj[k], rtol=1e-9, atol=1e-12)
    for k in hkeys:
        assert z[k].ndim == 3  # (N, d, d) blocks


def test_failed_gn_step_dumps(tmp_path):
    """A non-finite GN step (NaN measurement) dumps, with the GN reason."""
    g = _converged_pair(tg2o.Graph, tslam2d)
    g.edges()[1].measurement = np.array([np.nan, 0.0, 0.0])
    tp = g.compile(device="cpu")
    done, td = _dump(tmp_path, "gn", tg2o.SparseOptimizer(
        tp, algorithm=tg2o.GaussNewton(), solver=tg2o.DenseSolver()))
    assert done == 0 and len(td) == 1
    z = np.load(td[0], allow_pickle=False)
    assert str(z["reason"]) == "non-finite chi2 after GN step"
    assert float(z["lambda"]) == 0.0


def test_no_dump_on_success(tmp_path):
    g = tg2o.Graph()
    g.add_vertex(0, tslam2d.VertexSE2, np.zeros(3), fixed=True)
    g.add_vertex(1, tslam2d.VertexSE2, np.array([0.9, 0.1, 0.05]))
    g.add_edge(tslam2d.EdgeSE2, [0, 1], np.array([1.0, 0.0, 0.0]),
               np.eye(3))
    p = g.compile(device="cpu")
    opt = tg2o.SparseOptimizer(p, algorithm=tg2o.LevenbergMarquardt(),
                               solver=tg2o.DenseSolver())
    opt.write_debug = str(tmp_path)
    opt.optimize(5)
    assert opt.chi2() < 1e-10
    # only FAILED steps dump — at most one file, at the end
    assert len(glob.glob(str(tmp_path / "*.npz"))) <= 1


# --------------------------------------------------------------------------- #
# export, viz
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def graphs():
    """The same manhattan and sphere graphs in both packages (read from the
    port generator's ``.g2o`` text), and their optimized estimates (the
    port's, float64 on the CPU)."""
    out = {}
    for name, make, kw in (
            ("manhattan", t_manhattan, dict(n_poses=40, seed=1)),
            ("sphere", t_sphere,
             dict(nodes_per_level=8, laps=3, radius=10.0, seed=0))):
        text = tio.dumps(make(**kw))
        jg, tg = jio.loads(text), tio.loads(text)
        tp = tg.compile(device="cpu")
        tg2o.SparseOptimizer(tp, solver=tg2o.DenseSolver()).optimize(3)
        out[name] = (jg, tg, tp)
    return out


@pytest.mark.parametrize("name", ["manhattan", "sphere"])
def test_export_matches_jax(tmp_path, graphs, name):
    jg, tg, tp = graphs[name]
    est = tp.estimates_by_vid()
    for est_arg in (None, est):
        jexport.write_gnuplot(jg, str(tmp_path / "j.dat"),
                              estimates_by_vid=est_arg)
        texport.write_gnuplot(tg, str(tmp_path / "t.dat"),
                              estimates_by_vid=est_arg)
        assert (tmp_path / "t.dat").read_text() == \
            (tmp_path / "j.dat").read_text()
    for me in (None, 10):
        jexport.write_dot(jg, str(tmp_path / "j.dot"), max_edges=me)
        texport.write_dot(tg, str(tmp_path / "t.dot"), max_edges=me)
        dot = (tmp_path / "t.dot").read_text()
        assert dot == (tmp_path / "j.dot").read_text()
        assert dot.startswith("graph g2o") and "v0 --" in dot
    dat = (tmp_path / "t.dat").read_text()
    assert "# edges" in dat and "# vertices" in dat


@pytest.mark.parametrize("name", ["manhattan", "sphere"])
def test_render_html_matches_jax(tmp_path, graphs, name):
    jg, tg, tp = graphs[name]
    est = tp.estimates_by_vid()
    chi = tviz.edge_chi2_values(tp)
    assert chi.shape == (tg.num_edges,) and np.all(chi >= 0)
    for kw in (dict(), dict(chi2_by_edge=chi)):
        jviz.render_html(jg, str(tmp_path / "j.html"), estimates_by_vid=est,
                         title="t", **kw)
        tviz.render_html(tg, str(tmp_path / "t.html"), estimates_by_vid=est,
                         title="t", **kw)
        text = (tmp_path / "t.html").read_text()
        assert text == (tmp_path / "j.html").read_text()
        assert "canvas" in text and '"P":' in text
    frames = [{vid: r.estimate for vid, r in tg.vertices().items()}, est]
    jviz.render_replay_html(jg, str(tmp_path / "j.html"), frames, [2.0, 1.0],
                            title="r")
    tviz.render_replay_html(tg, str(tmp_path / "t.html"), frames, [2.0, 1.0],
                            title="r")
    assert (tmp_path / "t.html").read_text() == \
        (tmp_path / "j.html").read_text()
    with pytest.raises(ValueError):
        tviz.render_replay_html(tg, str(tmp_path / "x.html"), [])


def test_render_graph(tmp_path, graphs):
    pytest.importorskip("matplotlib")
    _, tg, tp = graphs["manhattan"]
    png = tmp_path / "m.png"
    tviz.render_graph(tg, str(png), estimates_by_vid=tp.estimates_by_vid(),
                      chi2_by_edge=tviz.edge_chi2_values(tp),
                      title="manhattan")
    assert png.stat().st_size > 2000
    _, tg3, tp3 = graphs["sphere"]
    svg = tmp_path / "s.svg"
    tviz.render_graph(tg3, str(svg), estimates_by_vid=tp3.estimates_by_vid())
    assert svg.stat().st_size > 2000


def test_render_graph_without_matplotlib(tmp_path, graphs, monkeypatch):
    """-plot needs matplotlib; without it the error says so (the HTML
    renderers above need nothing past numpy)."""
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    _, tg, _ = graphs["manhattan"]
    with pytest.raises(ImportError, match="needs matplotlib"):
        tviz.render_graph(tg, str(tmp_path / "m.png"))


def test_utils_exports():
    import g2o_tpu.utils as jutils
    import g2o_tpu_torch.utils as tutils

    assert tutils.__all__ == jutils.__all__
