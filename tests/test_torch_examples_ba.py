"""Port parity of the bundle-adjustment examples ``ba_demo``,
``sba_demo`` (mono and stereo), ``data_convert``,
``ba_anchored_inverse_depth`` and ``bal_example``
(``g2o_tpu_torch/examples``) against the JAX package's scripts in
``examples/``: each run in-process at its own size, the JAX script with
``sys.argv`` patched, the port's with ``-device cpu``, both in float64.

Tolerances: the printed lines equal with the run's times taken out,
every printed number within rtol 1e-6 of the JAX script's or one unit of
its last printed digit (the LM loop's ``iteration=`` lines by their
chi2, which past its floor may run an iteration longer in one package:
``_example_runs.assert_same_output``); the written files:
``data_convert``'s graph as text byte for byte (the same numpy scene, 10
printed digits), ``bal_example``'s point cloud to 1e-5 (6 printed
decimals, an f64 LM run of 20 iterations summed in another order)."""

import numpy as np
import pytest
import torch

import g2o_tpu.types  # noqa: F401
from _example_runs import assert_same_output, run


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops on one thread while this module runs: the suite
    runs six worker processes on a shared host, where every process's
    default thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(tmp_path, name, args):
    out = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        d.mkdir(exist_ok=True)
        out[pkg] = (*run(pkg, name, args, str(d)), d)
    return out


@pytest.mark.parametrize("name,args", [
    ("ba_demo", []), ("sba_demo", []), ("sba_demo", ["0.5", "mono"]),
    ("ba_anchored_inverse_depth", [])])
def test_example_matches_jax(tmp_path, name, args):
    res = _both(tmp_path, name, args)
    assert res["torch"][0] == res["jax"][0]
    assert_same_output(res["torch"][1], res["jax"][1])


def test_data_convert_matches_jax(tmp_path):
    res = _both(tmp_path, "data_convert", [])
    assert res["torch"][0] == res["jax"][0] == 0
    assert res["torch"][1] == res["jax"][1]
    assert "round-trip OK" in res["torch"][1]
    name = "converted_slam3d.g2o"
    assert (res["torch"][2] / name).read_text() == \
        (res["jax"][2] / name).read_text()


def test_data_convert_files(tmp_path):
    """The two-argument form: an SBA file in, a slam3d file out."""
    from g2o_tpu_torch.examples import data_convert, sba_demo
    from g2o_tpu_torch.io import g2o_format

    g, _ = sba_demo.make_rig(stereo=True, pixel_noise=0.5, seed=3)
    src = tmp_path / "sba.g2o"
    g2o_format.save(g, str(src))
    res = _both(tmp_path, "data_convert", [str(src), "out.g2o"])
    assert res["torch"][1] == res["jax"][1]
    text = (res["torch"][2] / "out.g2o").read_text()
    assert text == (res["jax"][2] / "out.g2o").read_text()
    assert text.startswith("PARAMS_CAMERACALIB 0")
    g_out = data_convert.convert(g)
    assert len(g_out.edges()) == sum(
        e.etype.name == "EDGE_PROJECT_P2SC" for e in g.edges())


def test_bal_example_matches_jax(tmp_path):
    res = _both(tmp_path, "bal_example", [])
    assert res["torch"][0] == res["jax"][0] == 0
    assert_same_output(res["torch"][1], res["jax"][1])
    pts = {pkg: np.loadtxt(res[pkg][2] / "synthetic_bal.ply", skiprows=7)
           for pkg in res}
    assert pts["torch"].shape == (2000, 3)
    np.testing.assert_allclose(pts["torch"], pts["jax"], rtol=0, atol=1e-5)
