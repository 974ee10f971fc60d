"""Port parity of the ``g2o`` command-line tool (``apps/cli.py``): both
packages' CLIs run on the same small ``.g2o`` files, the JAX package's
with ``-fp64`` and the port's with ``-fp64 -device cpu``, and their
outputs are compared — the written graph (estimates to rtol 1e-8 / atol
1e-9 after the text's 10 digits), the ``-stats`` rows and ``-summary``
(chi2 to rtol 1e-9, iteration and trial counts exactly), the stdout and
stderr lines with their times taken out, and the export files byte for
byte.  The JAX package's own CLI tests (``tests/test_cli_and_guess.py``)
are mirrored on the port."""

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import g2o_tpu.types  # noqa: F401
from g2o_tpu.apps import cli as jcli
from g2o_tpu_torch.apps import cli as tcli
from g2o_tpu_torch.core.types import REGISTRY as TREGISTRY
from g2o_tpu_torch.io import g2o_format as tio
from g2o_tpu_torch.sim.generators import create_ba_scene, create_manhattan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-9


def _run(cli, args):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(args)
    return rc, out.getvalue(), err.getvalue()


def _untimed(text):
    """Lines with the seconds (which differ run to run) taken out."""
    text = re.sub(r"\(\d+\.\d+ s\)", "(s)", text)
    text = re.sub(r", \d+\.\d+ s\)", ", s)", text)
    return [ln for ln in text.splitlines()
            if not ln.startswith("# warning")]


def _both(tmp_path, args):
    """Run both CLIs with ``args`` (``{out}`` in an argument names the
    package's own output directory, and stands for it in the printed
    lines); returns ``{pkg: (rc, stdout, stderr, dir)}``."""
    res = {}
    for pkg, cli, extra in (("jax", jcli, ["-fp64"]),
                            ("torch", tcli, ["-fp64", "-device", "cpu"])):
        d = tmp_path / pkg
        d.mkdir(exist_ok=True)
        a = [x.replace("{out}", str(d)) for x in args]
        rc, out, err = _run(cli, extra + a)
        res[pkg] = (rc, out.replace(str(d), "{out}"),
                    err.replace(str(d), "{out}"), d)
    return res


def _same_graph_files(a, b):
    ga, gb = tio.load(str(a)), tio.load(str(b))
    assert sorted(ga.vertices()) == sorted(gb.vertices())
    for vid, r in ga.vertices().items():
        np.testing.assert_allclose(gb.vertex(vid).estimate, r.estimate,
                                   rtol=1e-8, atol=1e-9)
        assert gb.vertex(vid).fixed == r.fixed
    assert len(ga.edges()) == len(gb.edges())


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    out = {}
    for name, n, seed in (("m50", 50, 8), ("m40", 40, 10), ("m120", 120, 2),
                          ("m10", 10, 8)):
        path = str(d / f"{name}.g2o")
        tio.save(create_manhattan(n_poses=n, seed=seed), path)
        out[name] = path
    return out


# --------------------------------------------------------------------------- #
# batch runs against the JAX CLI
# --------------------------------------------------------------------------- #

CASES = {
    "lm_pcg_huber": ["-solver", "lm_pcg", "-robustKernel", "Huber"],
    "lm_dense": ["-solver", "lm_dense"],
    "gn_supernodal": ["-solver", "gn_supernodal"],
    "dl_dense": ["-solver", "dl_dense"],
    "lm_supernodal_fused": ["-solver", "lm_supernodal", "-fused",
                            "-robustKernel", "Cauchy",
                            "-robustKernelWidth", "0.5"],
    "lm_pcg_fused_gain": ["-solver", "lm_pcg", "-fused", "-i", "-40"],
    "gn_host_chol_guess": ["-solver", "gn_host_chol", "-guess", "-i", "5"],
    "lm_sparse_chol": ["-solver", "lm_sparse_chol", "-i", "6"],
    "lm_cgls": ["-solver", "lm_cgls", "-i", "6"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_matches_jax(tmp_path, files, case):
    res = _both(tmp_path, ["-i", "10"] + CASES[case] + [
        "-o", "{out}/o.g2o", "-stats", "{out}/stats.jsonl",
        "-summary", "{out}/summary.jsonl", files["m50"]])
    (jrc, jout, jerr, jd), (trc, tout, terr, td) = res["jax"], res["torch"]
    assert trc == jrc == 0
    assert tout == jout
    # the final chi2 line to its printed digits
    assert _untimed(terr) == _untimed(jerr)
    _same_graph_files(jd / "o.g2o", td / "o.g2o")
    js = [json.loads(r) for r in open(jd / "stats.jsonl")]
    ts = [json.loads(r) for r in open(td / "stats.jsonl")]
    assert len(ts) == len(js) >= 1
    for a, b in zip(ts, js):
        assert a.keys() == b.keys()
        for k in a:
            if k == "chi2":
                assert a[k] == pytest.approx(b[k], rel=RTOL)
            elif k in ("iteration", "levenberg_iterations", "num_edges",
                       "num_vertices"):
                assert a[k] == b[k], k
    jsum = json.loads(open(jd / "summary.jsonl").read().splitlines()[-1])
    tsum = json.loads(open(td / "summary.jsonl").read().splitlines()[-1])
    assert tsum.keys() == jsum.keys()
    assert tsum["iterations"] == jsum["iterations"] >= 1
    assert tsum["final_chi2"] == pytest.approx(jsum["final_chi2"], rel=RTOL)
    assert tsum["solver"] == jsum["solver"]
    assert tio.load(str(td / "o.g2o")).num_vertices == 50


def test_cli_gain_termination(tmp_path, files):
    summary = str(tmp_path / "summary.jsonl")
    rc, _, _ = _run(tcli, ["-device", "cpu", "-i", "-50", "-solver",
                           "lm_dense", "-summary", summary, files["m50"]])
    assert rc == 0
    row = json.loads(open(summary).read().strip().splitlines()[-1])
    assert row["iterations"] < 50


def test_cli_lists():
    for flag in ("-listSolvers", "-listKernels"):
        trc, tout, _ = _run(tcli, [flag])
        jrc, jout, _ = _run(jcli, [flag])
        assert trc == jrc == 0 and tout == jout
    out = _run(tcli, ["-listSolvers"])[1]
    assert "lm_pcg" in out and "gn_dense" in out and "dl_cgls" in out
    out = _run(tcli, ["-listKernels"])[1]
    assert "Huber" in out and "DCS" in out
    rc, out, _ = _run(tcli, ["-listTypes"])
    assert rc == 0
    assert "VERTEX_SE2" in out and "EDGE_SIM3:EXPMAP" in out

    def static(text):
        # a variable-arity tag's factory registers an edge type per arity
        # that an earlier test loaded (EDGE_SE3_LOTSOF_XYZ_<k>), in each
        # package's registry; the rest is the same in both
        dynamic = "|".join(TREGISTRY._dynamic_edge_by_tag)
        return {t for t in text.split()
                if not re.fullmatch(rf"({dynamic})_\d+", t)}

    assert static(out) == static(_run(jcli, ["-listTypes"])[1])


def test_cli_unknown_solver(files):
    for cli, extra in ((tcli, ["-device", "cpu"]), (jcli, [])):
        rc, _, err = _run(cli, extra + ["-solver", "bogus", files["m10"]])
        assert rc == 1 and "unknown solver 'bogus'" in err


def test_cli_rename_and_properties(tmp_path, files):
    inp = str(tmp_path / "alien.g2o")
    text = open(files["m40"]).read().replace("VERTEX_SE2", "VERTEX_SE2_ALIEN") \
        .replace("EDGE_SE2", "EDGE_SE2_ALIEN")
    open(inp, "w").write(text)
    res = _both(tmp_path, [
        "-i", "5", "-solver", "lm_pcg", "-renameTypes",
        "VERTEX_SE2_ALIEN=VERTEX_SE2,EDGE_SE2_ALIEN=EDGE_SE2",
        "-solverProperties", "max_iter=37,tol=1e-7,bogus=3",
        "-printSolverProperties", "-o", "{out}/o.g2o", inp])
    (jrc, _, jerr, jd), (trc, _, terr, td) = res["jax"], res["torch"]
    assert trc == jrc == 0
    assert "PCGSolver.max_iter = 100" in terr
    assert "# warning: unknown solver property 'bogus'" in terr
    _same_graph_files(jd / "o.g2o", td / "o.g2o")


def test_cli_ate_report(tmp_path, files):
    res = _both(tmp_path, ["-i", "5", "-solver", "lm_pcg", "-gt",
                           files["m40"], files["m40"]])
    (jrc, jout, _, _), (trc, tout, _, _) = res["jax"], res["torch"]
    assert trc == jrc == 0
    assert "ATE(rmse)=" in tout and tout == jout


@pytest.mark.parametrize("solver,props", [
    ("lm_pcg", None),
    ("lm_pcg", "precond=chunk2,chunk_size=16,precond_mode=frozen"),
    ("gn_dense", None)])
def test_cli_incremental_matches_jax(tmp_path, files, solver, props):
    args = ["-inc", "-update", "10", "-incIterations", "1", "-solver",
            solver, "-o", "{out}/o.g2o", files["m120"]]
    if props:
        args[-3:-3] = ["-solverProperties", props]
    res = _both(tmp_path, args)
    (jrc, _, jerr, jd), (trc, _, terr, td) = res["jax"], res["torch"]
    assert trc == jrc == 0
    # "final chi2= ... (120 vertices, R recompiles, s)": chi2 to its
    # printed digits, the recompiles count exactly
    assert _untimed(terr) == _untimed(jerr)
    _same_graph_files(jd / "o.g2o", td / "o.g2o")


def test_cli_incremental_supernodal_c5(tmp_path, files):
    """C.5 through the CLI: the port's -inc with supernodal ends at the
    batch optimum (the JAX CLI's at 177.63 on this file)."""
    rc, out, err = _run(tcli, [
        "-device", "cpu", "-fp64", "-inc", "-update", "10", "-solver",
        "lm_supernodal", "-gt", files["m120"], files["m120"]])
    assert rc == 0
    chi = float(re.search(r"final chi2= (\S+)", err).group(1))
    assert chi == pytest.approx(34.98526, rel=1e-6)
    assert "1 recompiles" in err
    # -gt reports in incremental mode too
    assert "ATE(rmse)=" in out and "over 120 poses" in out


def test_cli_guess_linear(tmp_path, files):
    res = _both(tmp_path, ["-guessLinear", "-solver", "gn_dense", "-i", "3",
                           "-o", "{out}/o.g2o", files["m120"]])
    (jrc, _, jerr, jd), (trc, _, terr, td) = res["jax"], res["torch"]
    assert trc == jrc == 0
    assert "# linear 2D initialization for 120 poses" in terr
    assert _untimed(terr) == _untimed(jerr)
    _same_graph_files(jd / "o.g2o", td / "o.g2o")


def test_cli_marginalize(tmp_path):
    g, _ = create_ba_scene(n_cameras=6, n_points=40, seed=3)
    inp = str(tmp_path / "ba.g2o")
    tio.save(g, inp)
    res = _both(tmp_path, ["-marginalize", "-solver", "lm_schur", "-i", "5",
                           "-o", "{out}/o.g2o", inp])
    (jrc, _, jerr, jd), (trc, _, terr, td) = res["jax"], res["torch"]
    assert trc == jrc == 0
    assert "# marginalized" in terr
    assert _untimed(terr) == _untimed(jerr)
    _same_graph_files(jd / "o.g2o", td / "o.g2o")


def test_cli_write_debug(tmp_path):
    """-writeDebug on an exactly-converged input (chi2 == 0): the first LM
    step fails and dumps the JAX package's keys, as the JAX CLI does."""
    conv = str(tmp_path / "conv.g2o")
    open(conv, "w").write(
        "VERTEX_SE2 0 0 0 0\nVERTEX_SE2 1 1 0 0\nVERTEX_SE2 2 2 1 0\n"
        "FIX 0\n"
        "EDGE_SE2 0 1 1 0 0 1 0 0 1 0 1\n"
        "EDGE_SE2 1 2 1 1 0 1 0 0 1 0 1\n")
    res = _both(tmp_path, ["-solver", "lm_dense", "-i", "3", "-fused",
                           "-writeDebug", "{out}/dbg", conv])
    for pkg in ("jax", "torch"):
        rc, _, err, d = res[pkg]
        assert rc == 0
        assert "-writeDebug needs per-iteration host inspection" in err
        assert "step failed (LM exhausted 10 trials" in err
    jf = sorted(os.listdir(res["jax"][3] / "dbg"))
    tf = sorted(os.listdir(res["torch"][3] / "dbg"))
    assert tf == jf == ["g2o_tpu_debug_it0.npz"]
    z = np.load(res["torch"][3] / "dbg" / tf[0])
    zj = np.load(res["jax"][3] / "dbg" / jf[0])
    assert sorted(z.files) == sorted(zj.files)
    np.testing.assert_allclose(z["H_diag_VERTEX_SE2"],
                               zj["H_diag_VERTEX_SE2"], rtol=RTOL)


def test_cli_exports(tmp_path, files):
    res = _both(tmp_path, [
        "-solver", "lm_dense", "-i", "5", "-gnudump", "{out}/g.dat",
        "-dumpGraphviz", "{out}/g.dot", "-htmlPlot", "{out}/g.html",
        files["m40"]])
    assert res["torch"][0] == res["jax"][0] == 0
    for f in ("g.dat", "g.dot", "g.html"):
        a = (res["torch"][3] / f).read_text()
        b = (res["jax"][3] / f).read_text().replace(
            str(res["jax"][3]), str(res["torch"][3]))
        assert a == b, f
    # the replay forces the host loop and records one frame per iteration
    res = _both(tmp_path, ["-solver", "lm_dense", "-i", "4", "-fused",
                           "-replayHtml", "{out}/r.html", files["m40"]])
    (jrc, _, jerr, jd), (trc, _, terr, td) = res["jax"], res["torch"]
    assert trc == jrc == 0
    assert "(5 frames)" in terr
    assert (td / "r.html").read_text() == (jd / "r.html").read_text()


def test_cli_plot(tmp_path, files):
    pytest.importorskip("matplotlib")
    png = str(tmp_path / "o.png")
    rc, _, err = _run(tcli, ["-device", "cpu", "-i", "3", "-solver",
                             "lm_dense", "-plot", png, files["m40"]])
    assert rc == 0 and os.path.getsize(png) > 2000
    assert f"wrote {png}" in err


def test_cli_float32_default(tmp_path, files):
    """Without -fp64 the problem is float32, as the JAX CLI is on its
    accelerator; the run still converges."""
    summary = str(tmp_path / "s.jsonl")
    rc, _, err = _run(tcli, ["-device", "cpu", "-i", "10", "-solver",
                             "lm_pcg", "-summary", summary, files["m50"]])
    assert rc == 0
    chi32 = json.loads(open(summary).read().splitlines()[-1])["final_chi2"]
    summary64 = str(tmp_path / "s64.jsonl")
    _run(tcli, ["-device", "cpu", "-fp64", "-i", "10", "-solver", "lm_pcg",
                "-summary", summary64, files["m50"]])
    chi64 = json.loads(open(summary64).read().splitlines()[-1])["final_chi2"]
    assert chi32 == pytest.approx(chi64, rel=1e-4)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA card is here")
def test_cli_without_card_is_an_error(files):
    """The CLI runs on the card by default and never falls back to the
    CPU: without a card it stops with an error."""
    with pytest.raises(SystemExit) as exc:
        _run(tcli, ["-i", "1", files["m10"]])
    assert exc.value.code == 2


def test_cli_module_entry_point(files, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    r = subprocess.run(
        [sys.executable, "-m", "g2o_tpu_torch.apps.cli", "-device", "cpu",
         "-i", "3", "-solver", "lm_dense", "-o", str(tmp_path / "o.g2o"),
         files["m10"]], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "final chi2=" in r.stderr
    assert tio.load(str(tmp_path / "o.g2o")).num_vertices == 10
