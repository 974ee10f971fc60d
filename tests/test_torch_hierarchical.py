"""Port parity of ``apps/hierarchical.py`` against the JAX package's, on
the CPU in float64, on the scenes of ``tests/test_hierarchical.py``: the
300-pose manhattan, a small sphere, three levels, the 2D and 3D landmark
scenes, and the rejection of mixed types.

Tolerances: the summary's counts exactly, its final chi2 to rtol 1e-8
and every vertex estimate to 1e-7 absolute (three LM runs and a marginals
solve, summed in another order: the 3D landmark scene's estimates part by
up to 1.1e-8); the group operations to 1e-14."""

import numpy as np
import pytest
import torch

import g2o_tpu.types  # noqa: F401
from g2o_tpu.apps import hierarchical as jhier
from g2o_tpu.io import g2o_format as jio
from g2o_tpu.sim import generators as jgen
from g2o_tpu_torch.apps import hierarchical as thier
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

HIER_CASES = {
    "manhattan": (("create_manhattan", dict(n_poses=300, seed=17)),
                  dict(star_radius=5, star_iterations=8,
                       skeleton_iterations=20, refine_iterations=8)),
    "sphere": (("create_sphere", dict(nodes_per_level=10, laps=3, radius=10,
                                      seed=5)),
               dict(star_radius=4, star_iterations=8,
                    skeleton_iterations=15, refine_iterations=8)),
    "three_levels": (("create_manhattan", dict(n_poses=400, seed=23)),
                     dict(star_radius=2, star_iterations=6,
                          skeleton_iterations=12, refine_iterations=6,
                          max_levels=3, recurse_threshold=40)),
    "landmarks_2d": (("create_simulator2d", dict(
        n_poses=250, n_landmarks=50, sensors=("odometry", "pose", "pointxy"),
        seed=3)),
        dict(star_radius=5, star_iterations=8, skeleton_iterations=20,
             refine_iterations=10)),
    "landmarks_3d": (("create_simulator3d", dict(
        n_poses=60, n_landmarks=40, sensors=("odometry", "trackxyz"),
        seed=7)),
        dict(star_radius=4, star_iterations=8, skeleton_iterations=15,
             refine_iterations=8)),
}


@pytest.mark.parametrize("case", sorted(HIER_CASES))
def test_hierarchical_matches_jax(case):
    (make, scene), kw = HIER_CASES[case]
    if make == "create_sphere":
        # the two packages' sphere generators draw their noise from
        # different generators: both read the port's graph as text
        text = tio.dumps(tgen.create_sphere(**scene))
        gj, gt = jio.loads(text), tio.loads(text)
    else:
        gj = getattr(jgen, make)(**scene)
        gt = getattr(tgen, make)(**scene)
    p0 = gt.compile(device="cpu")
    chi0 = float(p0.chi2_fn(p0.data, p0.estimates)[0])
    rj = jhier.optimize_hierarchical(gj, **kw)
    rt = thier.optimize_hierarchical(gt, device="cpu", **kw)
    for k in ("n_stars", "levels", "skeleton_vertices", "skeleton_edges"):
        assert rt[k] == rj[k], k
    assert rt["final_chi2"] == pytest.approx(rj["final_chi2"], rel=1e-8)
    assert rt["final_chi2"] < chi0
    for vid, r in gj.vertices().items():
        np.testing.assert_allclose(gt.vertex(vid).estimate, r.estimate,
                                   rtol=0, atol=1e-7)
    if case == "three_levels":
        assert rt["levels"] == 3


def test_hierarchical_rejects_mixed_types():
    g, _ = tgen.create_ba_scene(n_cameras=3, n_points=10, seed=2)
    with pytest.raises(NotImplementedError):
        thier.optimize_hierarchical(g, device="cpu")


def test_hierarchical_stage_timers(monkeypatch):
    from g2o_tpu_torch.utils import tictoc

    monkeypatch.setenv("G2O_ENABLE_TICTOC", "1")
    monkeypatch.setattr(tictoc, "_STATS", {})
    g = tgen.create_manhattan(n_poses=80, seed=1)
    thier.optimize_hierarchical(g, star_radius=3, star_iterations=3,
                                skeleton_iterations=3, refine_iterations=3,
                                device="cpu")
    st = tictoc.stats()
    for k in ("stars", "marginals", "skeleton", "refine"):
        assert st[f"hierarchical_{k}"]["count"] >= 1


def test_group_ops_match_jax():
    rng = np.random.default_rng(1)
    for name in ("VERTEX_SE2", "VERTEX_SE3:QUAT"):
        if name == "VERTEX_SE2":
            a, b = rng.normal(size=3), rng.normal(size=3)
            pt = rng.normal(size=2)
        else:
            a = np.concatenate([rng.normal(size=3), rng.normal(size=4)])
            b = np.concatenate([rng.normal(size=3), rng.normal(size=4)])
            a[3:] /= np.linalg.norm(a[3:])
            b[3:] /= np.linalg.norm(b[3:])
            pt = rng.normal(size=3)
        jo, to = jhier._GROUP_OPS[name], thier._GROUP_OPS[name]
        np.testing.assert_allclose(to["compose"](a, b), jo["compose"](a, b),
                                   atol=1e-14)
        np.testing.assert_allclose(to["inverse"](a), jo["inverse"](a),
                                   atol=1e-14)
        np.testing.assert_allclose(to["act"](a, pt), jo["act"](a, pt),
                                   atol=1e-14)
        assert to["edge"] == jo["edge"]
