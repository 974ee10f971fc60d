"""Port parity of the array-direct ``.g2o`` loader: ``native/fastparse.cpp``
(byte for byte the JAX package's), ``native.parse_blocks`` and
``io/g2o_fast.load_problem`` against the JAX package's, on the CPU in
float64.

Tolerances: the parsed blocks and the loaded problems' arrays (estimates,
vertex indices, information, kernels, parameters, fixed and marginalized
flags) are equal bit for bit — both tokenizers are the same C++ source and
both loaders apply the same float64 conversions; chi2 of the loaded
problem to rtol 1e-12 and after 5 LM iterations to rtol 1e-9 (the two
packages sum in different orders), as ``tests/test_fastparse.py`` holds
the JAX loader against its object loader.  The analytic FLOP model of
``utils/flops.py`` gives the JAX package's counts to rtol 1e-12."""

import os

import numpy as np
import pytest
import torch

import g2o_tpu.types  # noqa: F401
from g2o_tpu import native as jnative
from g2o_tpu.core.lm_fused import optimize_fused as joptimize_fused
from g2o_tpu.core.solvers.schur_implicit import (
    ImplicitSchurSolver as JImplicit)
from g2o_tpu.core.solvers import PCGSolver as JPCG
from g2o_tpu.io import g2o_fast as jfast
from g2o_tpu.sim import generators as jgen
from g2o_tpu.utils import flops as jflops
from g2o_tpu_torch import native as tnative
from g2o_tpu_torch.core.graph import Graph
from g2o_tpu_torch.core.lm_fused import optimize_fused
from g2o_tpu_torch.core.solvers import ImplicitSchurSolver, PCGSolver
from g2o_tpu_torch.io import g2o_fast, g2o_format
from g2o_tpu_torch.sim.generators import (create_ba_scene, create_manhattan,
                                          create_sphere)
from g2o_tpu_torch.types.slam3d_addons import EdgeSE3Euler, VertexSE3Euler
from g2o_tpu_torch.utils import flops


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops on one thread while this module runs: the suite
    runs six worker processes on a shared host, where every process's
    default thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("fastparse")
    out = {}
    for name, g in (
            ("manhattan", create_manhattan(n_poses=200, seed=13)),
            ("sphere", create_sphere(nodes_per_level=6, laps=2, radius=5.0,
                                     seed=3))):
        out[name] = str(d / f"{name}.g2o")
        g2o_format.save(g, out[name])
    # both libraries' deprecated spellings beside the modern tags in one
    # file: every second vertex and edge line of the sphere written with
    # its alias (the fast loader once kept only one of two blocks that
    # resolve to one type)
    lines = open(out["sphere"]).read().splitlines()
    alias = []
    for i, ln in enumerate(lines):
        tag = ln.split()[0]
        if i % 2 and tag in ("VERTEX_SE3:QUAT", "EDGE_SE3:QUAT"):
            ln = "DEPRECATED_" + ln
        alias.append(ln)
    out["alias"] = str(d / "alias.g2o")
    with open(out["alias"], "w") as fh:
        fh.write("\n".join(alias) + "\n")
    # the sphere in the Euler types (VERTEX3 / EDGE3): numbers converted on
    # read, and the information turned from the Euler basis to the
    # residual's (info_from_io)
    gs = g2o_format.load(out["sphere"])
    ge = Graph()
    for vid, r in gs.vertices().items():
        ge.add_vertex(vid, VertexSE3Euler, r.estimate, fixed=r.fixed)
    for e in gs.edges():
        ge.add_edge(EdgeSE3Euler, e.vids, e.measurement, e.information)
    out["euler"] = str(d / "euler.g2o")
    g2o_format.save(ge, out["euler"])
    return out


def _same_blocks(a, b):
    assert list(a) == list(b)
    for tag in a:
        np.testing.assert_array_equal(a[tag][0], b[tag][0])
        np.testing.assert_array_equal(a[tag][1], b[tag][1])


def _same_problem(pj, pt):
    """Every array of a JAX ``Problem`` and a port ``Problem``, bit for
    bit."""
    assert list(pj.estimates) == list(pt.estimates)
    assert pj.total_dim == pt.total_dim
    assert dict(pj.vid_index) == dict(pt.vid_index)
    for t in pj.estimates:
        np.testing.assert_array_equal(np.asarray(pj.estimates[t]),
                                      pt.estimates[t].numpy())
        np.testing.assert_array_equal(np.asarray(pj.data.fixed[t]),
                                      pt.data.fixed[t].numpy())
        np.testing.assert_array_equal(np.asarray(pj.marginalized[t]),
                                      pt.marginalized[t])
    assert list(pj.data.edges) == list(pt.data.edges)
    for name, bj in pj.data.edges.items():
        bt = pt.data.edges[name]
        for f in bj._fields:
            np.testing.assert_array_equal(np.asarray(getattr(bj, f)),
                                          getattr(bt, f).numpy(), err_msg=f)


def _chi2(p):
    return float(p.chi2_fn(p.data, p.estimates)[0])


def test_fastparse_source_is_the_jax_packages():
    with open(os.path.join(ROOT, "g2o_tpu", "native", "fastparse.cpp"),
              "rb") as fh:
        ref = fh.read()
    with open(tnative.FASTPARSE_SOURCE, "rb") as fh:
        assert fh.read() == ref


@pytest.mark.parametrize("name", ["manhattan", "sphere", "alias", "euler"])
def test_parse_blocks_file(files, name):
    tb = tnative.parse_blocks(files[name])
    assert tb is not None, "the port's tokenizer did not build"
    _same_blocks(jnative.parse_blocks(files[name]), tb)


def test_parse_blocks_text():
    text = ("# comment line\nVERTEX_SE2 0 1.5 2.5 0.25\nFIX 0\n"
            "VERTEX_SE2 1 1e-3 -2 3.5\nEDGE_SE2 0 1 1 0 0 1 0 0 1 0 1\n"
            "PARAMS_SE2OFFSET 4 0.1 0.2\nFIX 1 3\n")
    tb = tnative.parse_blocks(text, is_text=True)
    _same_blocks(jnative.parse_blocks(text, is_text=True), tb)
    np.testing.assert_array_equal(tb["VERTEX_SE2"][0][0], [0, 1.5, 2.5, 0.25])
    assert np.isnan(tb["FIX"][0][0, 1]) and list(tb["FIX"][1]) == [1, 2]


def test_parse_blocks_missing_file(tmp_path):
    with pytest.raises(IOError):
        tnative.parse_blocks(str(tmp_path / "none.g2o"))


@pytest.mark.parametrize("name,kw", [
    ("manhattan", dict(kernel="Huber", delta=2.0)),
    ("sphere", {}),
    ("alias", dict(kernel="Cauchy", delta=0.5)),
    ("euler", {})])
def test_load_problem_matches_jax(files, name, kw):
    pj, aj = jfast.load_problem(files[name], **kw)
    pt, at = g2o_fast.load_problem(files[name], device="cpu", **kw)
    _same_problem(pj, pt)
    assert list(aj["params"]) == list(at["params"])
    assert _chi2(pt) == pytest.approx(
        float(pj.chi2_jit(pj.data, pj.estimates)[0]), rel=1e-12)


@pytest.mark.parametrize("name", ["manhattan", "sphere"])
def test_load_problem_lm_matches_jax(files, name):
    """5 LM iterations from the fast-loaded problem, as
    ``tests/test_fastparse.py`` runs them."""
    pj, _ = jfast.load_problem(files[name], kernel="Huber", delta=2.0)
    pt, _ = g2o_fast.load_problem(files[name], kernel="Huber", delta=2.0,
                                  device="cpu")
    rj = joptimize_fused(pj, JPCG(max_iter=100, tol=1e-10), 5)
    rt = optimize_fused(pt, PCGSolver(max_iter=100, tol=1e-10), 5)
    assert rt["iterations"] == rj["iterations"]
    np.testing.assert_allclose(rt["chi2_per_iteration"],
                               rj["chi2_per_iteration"], rtol=1e-9)
    assert rt["chi2_final"] == pytest.approx(rj["chi2_final"], rel=1e-9)


@pytest.mark.parametrize("name", ["manhattan", "sphere", "euler"])
def test_load_problem_matches_object_loader(files, name):
    """The fast loader's problem is the object loader's, with the same
    gauge."""
    pt, _ = g2o_fast.load_problem(files[name], device="cpu")
    g = g2o_format.load(files[name])
    if not any(r.fixed for r in g.vertices().values()):
        g.set_fixed(min(g.vertices()), True)
    po = g.compile(device="cpu")
    for t in po.estimates:
        np.testing.assert_array_equal(pt.estimates[t].numpy(),
                                      po.estimates[t].numpy())
        np.testing.assert_array_equal(pt.data.fixed[t].numpy(),
                                      po.data.fixed[t].numpy())
    for et, bo in po.data.edges.items():
        for f in ("vidx", "meas", "info", "param"):
            np.testing.assert_array_equal(
                getattr(pt.data.edges[et], f).numpy(),
                getattr(bo, f).numpy(), err_msg=f)


def _rows(p, name):
    b = p.data.edges[name]
    rows = np.concatenate([b.vidx.numpy(), b.meas.numpy(),
                           b.info.numpy().reshape(len(b.vidx), -1)], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def test_alias_file_loads_every_edge(files):
    """A file that mixes tags and their deprecated aliases loads to the
    problem of the file without aliases: the same vertices and the same
    edges (the aliased block follows the modern one, and none is
    dropped)."""
    pa, _ = g2o_fast.load_problem(files["alias"], device="cpu")
    ps, _ = g2o_fast.load_problem(files["sphere"], device="cpu")
    assert pa.num_edges == ps.num_edges
    for t in ps.estimates:
        np.testing.assert_array_equal(pa.estimates[t].numpy(),
                                      ps.estimates[t].numpy())
        np.testing.assert_array_equal(pa.data.fixed[t].numpy(),
                                      ps.data.fixed[t].numpy())
    for name in ps.data.edges:
        np.testing.assert_array_equal(_rows(pa, name), _rows(ps, name))
    assert _chi2(pa) == pytest.approx(_chi2(ps), rel=1e-12)


def test_load_problem_params_and_marginalize(tmp_path):
    """Parameter rows resolve per edge, landmarks are marginalized, and the
    gauge is the lowest pose id (not the lowest id, a landmark here)."""
    g, _ = create_ba_scene(n_cameras=4, n_points=30, seed=5)
    pose0 = min(v for v, r in g.vertices().items()
                if r.vtype.name == "VERTEX_SE3:EXPMAP")
    for r in g.vertices().values():
        r.fixed = False
    path = str(tmp_path / "ba.g2o")
    g2o_format.save(g, path)
    pj, _ = jfast.load_problem(path, marginalize=True)
    pt, at = g2o_fast.load_problem(path, marginalize=True, device="cpu")
    _same_problem(pj, pt)
    assert at["params"]
    t, i = pt.vid_index[pose0]
    assert bool(pt.data.fixed[t][i])
    assert sum(int(f.sum()) for f in pt.data.fixed.values()) == 1


def test_unknown_vertex_raises(tmp_path):
    path = str(tmp_path / "bad.g2o")
    with open(path, "w") as fh:
        fh.write("VERTEX_SE2 0 0 0 0\nEDGE_SE2 0 7 1 0 0 1 0 0 1 0 1\n")
    with pytest.raises(ValueError, match="unknown vertex id 7"):
        g2o_fast.load_problem(path, device="cpu")


def test_unknown_tag_raises(tmp_path):
    path = str(tmp_path / "bad.g2o")
    with open(path, "w") as fh:
        fh.write("VERTEX_SE2 0 0 0 0\nVERTEX_MARS 1 0 0\n")
    with pytest.raises(ValueError, match="unknown tag 'VERTEX_MARS'"):
        g2o_fast.load_problem(path, device="cpu")


def test_object_loader_fallback(files, monkeypatch, capsys):
    """Without the native library the object loader builds the same
    problem, and says so on stderr."""
    monkeypatch.setattr(tnative, "parse_blocks", lambda *a, **k: None)
    pf, aux = g2o_fast.load_problem(files["manhattan"], kernel="Huber",
                                    delta=2.0, device="cpu")
    assert aux == {}
    assert "object loader" in capsys.readouterr().err
    monkeypatch.undo()
    pn, _ = g2o_fast.load_problem(files["manhattan"], kernel="Huber",
                                  delta=2.0, device="cpu")
    for t in pn.estimates:
        np.testing.assert_array_equal(pf.estimates[t].numpy(),
                                      pn.estimates[t].numpy())
    assert _chi2(pf) == _chi2(pn)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA card is here")
def test_load_problem_default_device_needs_card(files):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        g2o_fast.load_problem(files["manhattan"])


# --------------------------------------------------------------------- #
# utils/flops.py
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("precond", ["jacobi", "chunk", "chunk2"])
def test_flops_pcg_match_jax(files, precond):
    pj, _ = jfast.load_problem(files["sphere"])
    pt, _ = g2o_fast.load_problem(files["sphere"], device="cpu")
    kw = dict(max_iter=50, tol=1e-8, precond=precond, chunk_size=4)
    rj = joptimize_fused(pj, JPCG(**kw), 3)
    rt = optimize_fused(pt, PCGSolver(**kw), 3)
    assert rt["cg_per_iteration"] == rj["cg_per_iteration"]
    for fn in ("linearize_flops", "chi2_flops", "matvec_flops"):
        assert getattr(flops, fn)(pt) == pytest.approx(
            getattr(jflops, fn)(pj), rel=1e-12)
    assert flops.run_flops(pt, PCGSolver(**kw), rt) == pytest.approx(
        jflops.run_flops(pj, JPCG(**kw), rj), rel=1e-12)


def test_flops_implicit_schur_match_jax():
    g, _ = create_ba_scene(n_cameras=5, n_points=40, seed=2)
    gj, _ = jgen.create_ba_scene(n_cameras=5, n_points=40, seed=2)
    pj = gj.compile()
    pt = g.compile(device="cpu")
    kw = dict(max_iter=100, tol=1e-8)
    rj = joptimize_fused(pj, JImplicit(**kw), 3)
    rt = optimize_fused(pt, ImplicitSchurSolver(**kw), 3)
    assert rt["cg_per_iteration"] == rj["cg_per_iteration"]
    assert flops.run_flops(pt, ImplicitSchurSolver(**kw), rt) == \
        pytest.approx(jflops.run_flops(pj, JImplicit(**kw), rj), rel=1e-12)


def test_flops_no_model_and_no_peak(files):
    pt, _ = g2o_fast.load_problem(files["sphere"], device="cpu")
    res = optimize_fused(pt, PCGSolver(), 2)
    # no model for a direct solver; no peak for the CPU
    from g2o_tpu_torch.core.solvers import DenseSolver

    assert flops.run_flops(pt, DenseSolver(), res) is None
    assert flops.mfu_report(pt, PCGSolver(), res) is None
    assert flops.device_peak_flops("cpu") is None


def test_flops_h100_peaks():
    """The published H100 figures by card name and dtype; no peak for a
    card or dtype missing from the table, and no TPU figure."""
    sxm = "NVIDIA H100 80GB HBM3"
    assert flops.device_peak_flops(sxm, torch.float32) == 67e12
    assert flops.device_peak_flops(sxm, torch.float64) == 67e12
    assert flops.device_peak_flops("NVIDIA H100 PCIe") == 51e12
    assert flops.device_peak_flops("NVIDIA A100-SXM4-80GB") is None
    assert flops.device_peak_flops(sxm, torch.float16) is None
    assert "_PEAK_BF16" not in vars(flops)


def test_mfu_report_with_a_named_card(files):
    pt, _ = g2o_fast.load_problem(files["sphere"], device="cpu")
    s = PCGSolver(max_iter=50, tol=1e-8)
    res = optimize_fused(pt, s, 3)
    rep = flops.mfu_report(pt, s, res, device="NVIDIA H100 80GB HBM3")
    assert rep["peak_flops_per_s"] == 67e12
    assert rep["peak_dtype"] == "float64"
    assert rep["algorithmic_flops"] == flops.run_flops(pt, s, res)
    assert rep["mfu_vs_peak"] == pytest.approx(
        rep["achieved_flops_per_s"] / 67e12)
    assert 0 < rep["mfu_vs_peak"] < 1
