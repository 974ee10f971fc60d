"""Port parity of the apps ``anonymize``, ``convert_segment_line`` and
``interactive`` against the JAX package's, on the CPU in float64, on the
scenes of ``tests/test_interactive.py`` and small simulator graphs
(``tests/test_torch_hierarchical.py`` holds ``hierarchical``).

Tolerances: the transformed graphs' ``.g2o`` text byte for byte (both
packages' simulators build the same graphs bit for bit and both writers
print 10 significant digits); the interactive responses as text (9
significant digits), exactly."""

import contextlib
import io
import sys

import numpy as np
import pytest
import torch

import g2o_tpu.types  # noqa: F401
from g2o_tpu.apps import anonymize as janon
from g2o_tpu.apps import convert_segment_line as jcsl
from g2o_tpu.apps import interactive as jinter
from g2o_tpu.io import g2o_format as jio
from g2o_tpu.sim import generators as jgen
from g2o_tpu_torch.apps import anonymize as tanon
from g2o_tpu_torch.apps import convert_segment_line as tcsl
from g2o_tpu_torch.apps import interactive as tinter
from g2o_tpu_torch.io import g2o_format as tio
from g2o_tpu_torch.sim import generators as tgen


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops on one thread while this module runs: the suite
    runs six worker processes on a shared host, where every process's
    default thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SEG_SCENE = dict(n_poses=80, n_landmarks=20, world_size=15.0, n_segments=12,
                 n_lines=4, seed=4,
                 sensors=("odometry", "pointxy", "segment", "segment_line",
                          "segment_pointline"))
ANON_SCENE = dict(n_poses=80, n_landmarks=20, world_size=15.0, seed=2,
                  sensors=("odometry", "pose", "pointxy", "bearing",
                           "pointxy_offset"))


# --------------------------------------------------------------------- #
# anonymize / convert_segment_line
# --------------------------------------------------------------------- #

def test_convert_segment_line_matches_jax():
    gj = jcsl.convert(jgen.create_simulator2d(**SEG_SCENE))
    gt = tcsl.convert(tgen.create_simulator2d(**SEG_SCENE))
    text = tio.dumps(gt)
    assert text == jio.dumps(gj)
    assert "VERTEX_LINE2D" in text and "EDGE_LINE2D_POINTXY" in text
    assert "SEGMENT" not in text
    p = gt.compile(device="cpu")
    assert np.isfinite(float(p.chi2_fn(p.data, p.estimates)[0]))


def test_line_parameters_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        a, b = rng.normal(size=2), rng.normal(size=2)
        np.testing.assert_array_equal(tcsl.line_parameters(a, b),
                                      jcsl.line_parameters(a, b))


def test_anonymize_matches_jax():
    gj = jgen.create_simulator2d(**ANON_SCENE)
    gt = tgen.create_simulator2d(**ANON_SCENE)
    nj, nt = janon.anonymize(gj), tanon.anonymize(gt)
    assert nt == nj > 0
    assert tio.dumps(gt) == jio.dumps(gj)
    # every observation of a landmark lost its landmark endpoint
    obs = [e for e in gt.edges() if e.etype.name in tanon.LANDMARK_EDGES]
    assert obs and all(e.vids[1] == tanon.UNASSIGNED for e in obs)


def test_anonymize_loop_closures():
    g = tgen.create_manhattan(n_poses=60, seed=3)
    loops = [e for e in g.edges() if abs(e.vids[0] - e.vids[1]) > 1]
    n = tanon.anonymize(g)
    assert n == len(loops) > 0
    for e in loops:
        assert tanon.UNASSIGNED in e.vids
    odo = [e for e in g.edges() if tanon.UNASSIGNED not in e.vids]
    assert all(abs(e.vids[0] - e.vids[1]) == 1 for e in odo)


@pytest.mark.parametrize("app", ["anonymize", "convert_segment_line"])
def test_app_main_matches_jax(tmp_path, app):
    mods = {"anonymize": (janon, tanon, ANON_SCENE),
            "convert_segment_line": (jcsl, tcsl, SEG_SCENE)}
    jm, tm, scene = mods[app]
    src = tmp_path / "in.g2o"
    tio.save(tgen.create_simulator2d(**scene), str(src))
    outs = {}
    for pkg, mod in (("jax", jm), ("torch", tm)):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert mod.main(["-o", str(tmp_path / f"{pkg}.g2o"),
                             str(src)]) == 0
        outs[pkg] = (err.getvalue(), (tmp_path / f"{pkg}.g2o").read_text())
    assert outs["torch"] == outs["jax"]


# --------------------------------------------------------------------- #
# interactive
# --------------------------------------------------------------------- #

SCRIPT_2D = """
    ADD VERTEX_XYT 0;
    ADD VERTEX_XYT 1;
    ADD EDGE_XYT 0 0 1 .1 .2 .3 1 0 0 1 0 1;
    FIX 0;
    SOLVE_STATE;
    QUERY_STATE;
    ADD VERTEX_XYT 2;
    ADD EDGE_XYT 1 1 2 .1 .2 .3 1 0 0 1 0 1;
    SOLVE_STATE;
    QUERY_STATE 1 2;
"""
SCRIPT_3D = """
    ADD VERTEX_XYZRPY 0;
    ADD VERTEX_XYZRPY 1;
    ADD EDGE_XYZRPY 0 0 1 .1 .2 .3 .01 .02 .03 1 0 0 0 0 0 1 0 0 0 0 1 0 0 0 1 0 0 1 0 1;
    FIX 0;
    SOLVE_STATE;
    QUERY_STATE;
"""


def _replay(srv, script):
    return [srv.handle_line(ln) for ln in script.strip().splitlines()]


def _manhattan_script(n, every):
    """A manhattan graph as protocol lines, ``SOLVE_STATE`` every
    ``every`` poses."""
    g = tgen.create_manhattan(n_poses=n, seed=5)
    lines = []
    for vid in sorted(g.vertices()):
        x = g.vertex(vid).estimate
        lines.append(f"ADD VERTEX_XYT {vid} "
                     + " ".join(f"{v:.17g}" for v in x) + ";")
    for k, e in enumerate(g.edges()):
        iu = e.information[np.triu_indices(3)]
        nums = (f"{v:.17g}" for v in (*e.measurement, *iu))
        lines.append(" ".join(["ADD EDGE_XYT", str(k), *map(str, e.vids),
                               *nums]) + ";")
        if (k + 1) % every == 0:
            lines.append("SOLVE_STATE;")
    return "\n".join(lines + ["SOLVE_STATE;", "QUERY_STATE;"])


@pytest.mark.parametrize("case", ["2d", "3d", "manhattan", "batch"])
def test_interactive_matches_jax(case):
    script, kw = {"2d": (SCRIPT_2D, dict(iterations=10)),
                  "3d": (SCRIPT_3D, dict(iterations=20)),
                  "manhattan": (_manhattan_script(60, 25), {}),
                  "batch": (_manhattan_script(40, 10 ** 6),
                            dict(solve_every=15))}[case]
    rj = _replay(jinter.InteractiveSlam(**kw), script)
    rt = _replay(tinter.InteractiveSlam(device="cpu", **kw), script)
    assert rt == rj
    last = rt[-1].splitlines()
    assert last[0] == "BEGIN" and last[-1] == "END"


def test_interactive_example_values():
    """``tests/test_interactive.py``'s checks on the port."""
    out = [r for r in _replay(tinter.InteractiveSlam(iterations=10,
                                                     device="cpu"),
                              SCRIPT_2D) if r is not None]
    lines = out[0].splitlines()
    np.testing.assert_allclose([float(x) for x in lines[2].split()[2:]],
                               [0.1, 0.2, 0.3], atol=1e-6)
    assert len(out[1].splitlines()) == 4
    out = [r for r in _replay(tinter.InteractiveSlam(iterations=20,
                                                     device="cpu"),
                              SCRIPT_3D) if r is not None]
    v1 = [float(x) for x in out[0].splitlines()[2].split()[2:]]
    np.testing.assert_allclose(v1[:3], [0.1, 0.2, 0.3], atol=1e-5)
    np.testing.assert_allclose(v1[3:], [0.01, 0.02, 0.03], atol=1e-4)


def test_interactive_unknown_command():
    srv = tinter.InteractiveSlam(device="cpu")
    assert srv.handle_line("FROBNICATE 1;") == \
        jinter.InteractiveSlam().handle_line("FROBNICATE 1;")
    assert "error" in srv.handle_line("ADD VERTEX_MARS 0;")
    assert srv.handle_line("# a comment") is None
    assert srv.handle_line("   ") is None


def test_rpy_quat_match_jax():
    rng = np.random.default_rng(4)
    for _ in range(20):
        rpy = rng.uniform(-1.4, 1.4, size=3)
        q = tinter._rpy_to_quat(rpy)
        np.testing.assert_allclose(q, jinter._rpy_to_quat(rpy), atol=1e-15)
        np.testing.assert_allclose(tinter._quat_to_rpy(q),
                                   jinter._quat_to_rpy(q), atol=1e-14)
        np.testing.assert_allclose(tinter._quat_to_rpy(q), rpy, atol=1e-12)


def test_interactive_main_stdin(monkeypatch, capsys):
    """``main`` over stdin, the port with ``-device cpu``."""
    outs = {}
    for pkg, mod, extra in (("jax", jinter, []),
                            ("torch", tinter, ["-device", "cpu"])):
        monkeypatch.setattr(sys, "stdin", io.StringIO(SCRIPT_2D))
        assert mod.main(["-i", "10"] + extra) == 0
        outs[pkg] = capsys.readouterr().out
    assert outs["torch"] == outs["jax"]
    assert outs["torch"].count("BEGIN") == 2


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA card is here")
def test_interactive_main_needs_card(monkeypatch):
    monkeypatch.setattr(sys, "stdin", io.StringIO(""))
    with pytest.raises(SystemExit), \
            contextlib.redirect_stderr(io.StringIO()):
        tinter.main([])
