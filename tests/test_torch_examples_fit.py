"""Port parity of the examples ``create_sphere``, ``simple_optimize``,
``g2o_unfold``, ``circle_fit``, ``curve_fit``, ``odom_calibration``,
``tutorial_slam2d``, ``target_tracking`` and ``gicp_demo``
(``g2o_tpu_torch/examples``) against the JAX package's scripts in
``examples/``: each run in-process at its own size, the JAX script with
``sys.argv`` patched as ``tests/test_unfold.py`` runs it, the port's with
``-device cpu``, both in float64 (the JAX examples enable x64 or run under
``conftest.py``'s).

Tolerances: the printed lines equal with the run's times taken out,
every printed number within rtol 1e-6 of the JAX script's or one unit of
its last printed digit (the LM loop's ``iteration=`` lines by their
chi2, which past its floor may run an iteration longer in one package:
``_example_runs.assert_same_output``); the returned estimates to 1e-9
absolute; the written graphs' estimates to 1e-8 (10 printed digits) and
the gnuplot dumps to 1e-6 (6 decimals). ``create_sphere`` draws its
noise from a ``torch.Generator`` where the JAX script draws it from
``jax.random``: its files hold the same vertices and edges, and their
values are not compared. The per-edge chi2 and region growing of
``g2o_unfold`` follow ``tests/test_unfold.py``. ``simple_optimize`` and
``g2o_unfold`` run the default ``PCGSolver`` (Jacobi, at most 100
iterations, tol 1e-6): on the 30-pose manhattan graph of
``tests/test_unfold.py`` its solves converge before the cap. Where a
solve stops at the cap (a 60-pose graph's first), the two packages'
rounding after 100 unconverged CG iterations parts their trajectories by
~4e-5, and the rtol above does not hold. Every other example here solves
with ``DenseSolver`` or a PCG that converges."""

import numpy as np
import pytest
import torch

import g2o_tpu.types  # noqa: F401
from _example_runs import assert_same_output, run
from g2o_tpu_torch.examples import g2o_unfold, split_device
from g2o_tpu_torch.io import g2o_format
from g2o_tpu_torch.sim.generators import create_manhattan


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops on one thread while this module runs: the suite
    runs six worker processes on a shared host, where every process's
    default thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

NO_ARGS = ("circle_fit", "curve_fit", "odom_calibration", "tutorial_slam2d",
           "target_tracking", "gicp_demo")


def _both(tmp_path, name, args):
    out = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        d.mkdir(exist_ok=True)
        a = [x.replace("{dir}", str(d)) for x in args]
        ret, text = run(pkg, name, a, str(d))
        out[pkg] = (ret, text.replace(str(d), "{dir}"), d)
    return out


@pytest.mark.parametrize("name", NO_ARGS)
def test_example_matches_jax(tmp_path, name):
    res = _both(tmp_path, name, [])
    (rj, tj, _), (rt, tt, _) = res["jax"], res["torch"]
    assert_same_output(tt, tj)
    if isinstance(rj, np.ndarray):
        np.testing.assert_allclose(rt, rj, rtol=0, atol=1e-9)
    else:
        assert rt == rj


def test_target_tracking_steps_arg(tmp_path):
    res = _both(tmp_path, "target_tracking", ["60"])
    assert_same_output(res["torch"][1], res["jax"][1])
    assert "edges= 119" in res["torch"][1]


def test_simple_optimize_matches_jax(tmp_path):
    src = tmp_path / "m.g2o"
    g2o_format.save(create_manhattan(n_poses=30, seed=4), str(src))
    res = _both(tmp_path, "simple_optimize", [str(src), "6"])
    assert res["torch"][0] == res["jax"][0] == 0
    # both write next to the input: the port's output replaced the JAX
    # script's, so each run is read back right after it ran
    assert_same_output(res["torch"][1].replace(str(src), "{src}"),
                       res["jax"][1].replace(str(src), "{src}"))
    assert "saved" in res["torch"][1]


def test_simple_optimize_written_graph(tmp_path):
    src = tmp_path / "m.g2o"
    g2o_format.save(create_manhattan(n_poses=30, seed=4), str(src))
    graphs = {}
    for pkg in ("jax", "torch"):
        assert run(pkg, "simple_optimize", [str(src), "6"],
                   str(tmp_path))[0] == 0
        graphs[pkg] = g2o_format.load(str(src) + ".optimized")
    for vid, r in graphs["jax"].vertices().items():
        np.testing.assert_allclose(graphs["torch"].vertex(vid).estimate,
                                   r.estimate, rtol=0, atol=1e-8)


def test_simple_optimize_usage(tmp_path):
    for pkg in ("jax", "torch"):
        ret, text = run(pkg, "simple_optimize", [], str(tmp_path))
        assert ret == 1 and text.startswith("usage:")


def test_create_sphere_matches_jax(tmp_path):
    res = _both(tmp_path, "create_sphere", ["{dir}/s.g2o", "8", "4"])
    assert res["torch"][1] == res["jax"][1]
    gj = g2o_format.load(str(res["jax"][2] / "s.g2o"))
    gt = g2o_format.load(str(res["torch"][2] / "s.g2o"))
    assert sorted(gt.vertices()) == sorted(gj.vertices())
    assert [e.vids for e in gt.edges()] == [e.vids for e in gj.edges()]
    assert [v for v, r in gt.vertices().items() if r.fixed] == \
        [v for v, r in gj.vertices().items() if r.fixed]


def test_g2o_unfold_main_matches_jax(tmp_path):
    """``tests/test_unfold.py``'s run of the example's ``main``."""
    src = tmp_path / "m.g2o"
    g2o_format.save(create_manhattan(n_poses=30, seed=4), str(src))
    res = _both(tmp_path, "g2o_unfold", [
        str(src), "-i", "3", "-maxCost", "1e9", "-gnudump",
        "{dir}/dump.dat", "-o", "{dir}/out.g2o"])
    assert res["torch"][0] == res["jax"][0] == 0
    assert_same_output(res["torch"][1], res["jax"][1])
    assert "selected" in res["torch"][1]
    dj, dt = res["jax"][2], res["torch"][2]
    np.testing.assert_allclose(np.loadtxt(dt / "dump_selected.dat"),
                               np.loadtxt(dj / "dump_selected.dat"),
                               rtol=0, atol=1e-6)
    gj = g2o_format.load(str(dj / "out.g2o"))
    gt = g2o_format.load(str(dt / "out.g2o"))
    for vid, r in gj.vertices().items():
        np.testing.assert_allclose(gt.vertex(vid).estimate, r.estimate,
                                   rtol=0, atol=1e-8)


def test_g2o_unfold_border(tmp_path):
    """A finite cost limit splits the region into selected and border
    edges, in both packages alike."""
    src = tmp_path / "m.g2o"
    g2o_format.save(create_manhattan(n_poses=40, seed=3), str(src))
    # the loop closures are the graph's only edges with chi2 > 0 (cost
    # below 1e6): grown from the worst, they are selected and the
    # odometry around them is the border
    res = _both(tmp_path, "g2o_unfold", [
        str(src), "-i", "2", "-maxCost", "999999", "-startEdge", "42",
        "-gnudump", "{dir}/dump.dat", "-v"])
    assert "selected 4 edges, border 6 edges" in res["torch"][1]
    assert_same_output(res["torch"][1], res["jax"][1])
    for part in ("selected", "border"):
        np.testing.assert_allclose(
            np.loadtxt(res["torch"][2] / f"dump_{part}.dat"),
            np.loadtxt(res["jax"][2] / f"dump_{part}.dat"),
            rtol=0, atol=1e-6)


def test_edge_chi2_matches_total():
    g = create_manhattan(n_poses=40, seed=3)
    p = g.compile(device="cpu")
    per_edge = p.edge_chi2_fn(p.data, p.estimates)
    total = sum(float(v.sum()) for v in per_edge.values())
    chi_r, _ = p.chi2_fn(p.data, p.estimates)
    assert abs(total - float(chi_r)) < 1e-9 * max(1.0, abs(float(chi_r)))


def test_region_growing_matches_jax():
    import examples.g2o_unfold as junfold
    import g2o_tpu.sim.generators as jgen

    gj, gt = jgen.create_manhattan(n_poses=40, seed=3), \
        create_manhattan(n_poses=40, seed=3)
    cj = junfold.edge_costs_inv_chi2(gj, gj.compile())
    ct = g2o_unfold.edge_costs_inv_chi2(gt, gt.compile(device="cpu"))
    np.testing.assert_allclose(ct, cj, rtol=1e-9)
    sel, border = g2o_unfold.find_connected_edges_with_cost_limit(
        gt, 0, ct, float("inf"))
    assert border == set() and len(sel) == gt.num_edges
    for cut in (float(np.median(ct)), float(np.percentile(ct, 20))):
        sel, border = g2o_unfold.find_connected_edges_with_cost_limit(
            gt, 0, ct, cut)
        assert (sel, border) == junfold.find_connected_edges_with_cost_limit(
            gj, 0, cj, cut)
        assert all(ct[i] <= cut for i in sel)
        assert all(ct[i] > cut for i in border)


def test_split_device():
    assert split_device(["a", "-device", "cpu", "b"]) == ("cpu", ["a", "b"])
    assert split_device(["a"]) == ("cuda", ["a"])
    with pytest.raises(SystemExit):
        split_device(["-device", "tpu"])


def test_output_difference():
    from g2o_tpu_torch.examples import output_difference

    lm = ("iteration= 0\t chi2= 5.000000\t time= {t}\t cumTime= {t}\t "
          "edges= 3\t lambda= {lam}\t levenbergIter= 1\n"
          "iteration= 1\t chi2= 4.000000\t time= 0.1\t cumTime= 0.2\n")
    a = lm.format(t="0.5", lam="2") + "x 1.23 (0.50s)\n"
    b = lm.format(t="9.1", lam="3") + "iteration= 2\t chi2= 4.000000\n" \
        + "x 1.23 (7.00s)\n"
    assert output_difference(a, b) is None      # times, λ, the floor line
    assert output_difference(a.replace("x 1.23", "x 1.25"), b) is not None
    assert output_difference(a, b.replace("chi2= 4.000000\nx",
                                          "chi2= 3.000000\nx")) is not None
    assert output_difference(a, "y 1.23\n" + a) is not None
    assert output_difference("e 1.04e-07", "e 1.0e-07") is None
    assert output_difference("e 1.0e-07", "e 1.3e-07") is not None
