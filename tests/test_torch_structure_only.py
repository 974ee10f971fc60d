"""Port parity of ``core/structure_only.py`` (every landmark's own LM at
once) against the JAX package, float64 on the CPU.

Both packages' ``create_ba_scene`` give the same scene bit for bit; each
package compiles it, and the refinement runs on each: the same batched
3x3 solves and per-landmark accept masks, in two summation orders.  The
per-landmark chi2 before and after agree to rtol 1e-10.  The refined
points agree to rtol 1e-10 on a noise-free scene and to rtol 1e-7 on
noisy ones: a point seen from a short baseline has a nearly flat depth
direction, along which the two summation orders' rounding grows over the
iterations (to 2.8e-8 relative on these scenes) while the point's chi2
stays equal to ~1e-13."""

import numpy as np
import pytest
import torch

import g2o_tpu.types  # noqa: F401
from g2o_tpu.core.structure_only import structure_only_refine as j_refine
from g2o_tpu.sim.generators import create_ba_scene as j_scene
from g2o_tpu.sim.generators import create_manhattan as j_manhattan
from g2o_tpu_torch.core.structure_only import structure_only_refine
from g2o_tpu_torch.sim.generators import create_ba_scene, create_manhattan

RTOL = 1e-10
POINT_RTOL = 1e-7


def _pair(kernel=None, **kw):
    jg, truth = j_scene(**kw)
    tg, ttruth = create_ba_scene(**kw)
    assert sorted(truth) == sorted(ttruth)
    if kernel is not None:
        jg.set_robust_kernel(kernel, 2.0)
        tg.set_robust_kernel(kernel, 2.0)
    return jg.compile(), tg.compile(device="cpu"), truth


def _assert_same(tp, jp, tres, jres, point_rtol=POINT_RTOL):
    assert tres.keys() == jres.keys()
    for t in jres:
        for a, b in zip(tres[t], jres[t]):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-12)
    for t in jp.vertex_types:
        np.testing.assert_allclose(tp.estimates[t].numpy(),
                                   np.asarray(jp.estimates[t]),
                                   rtol=point_rtol, atol=1e-12)


def test_structure_only():
    jp, tp, truth = _pair(n_cameras=8, n_points=60, pixel_noise=0.0,
                          point_noise=0.3, seed=11)
    res = structure_only_refine(tp, n_iters=15)
    (before, after), = res.values()
    assert after.sum() < 1e-6 * max(before.sum(), 1.0)
    # cameras untouched; points recovered exactly (noise-free observations)
    for vid, t in truth.items():
        np.testing.assert_allclose(tp.get_estimate(vid), t, atol=1e-4)
    _assert_same(tp, jp, res, j_refine(jp, n_iters=15), point_rtol=RTOL)


@pytest.mark.parametrize("kernel,n_iters", [(None, 10), ("Huber", 6),
                                            ("Cauchy", 10)])
def test_structure_only_matches_jax(kernel, n_iters):
    """Noisy pixels: every landmark's chi2 goes down (or stays), and the
    run is the JAX package's, robust kernels included."""
    jp, tp, _ = _pair(kernel=kernel, n_cameras=10, n_points=120,
                      pixel_noise=1.0, point_noise=0.2, seed=4)
    cams0 = {t: tp.estimates[t].clone() for t in tp.vertex_types
             if not tp.marginalized[t].all()}
    res = structure_only_refine(tp, n_iters=n_iters)
    (before, after), = res.values()
    assert np.all(after <= before + 1e-12)
    assert after.sum() < 0.5 * before.sum()
    for t, v in cams0.items():
        assert torch.equal(tp.estimates[t], v)
    _assert_same(tp, jp, res, j_refine(jp, n_iters=n_iters))


def test_structure_only_fixed_landmark_stays():
    jg, _ = j_scene(n_cameras=6, n_points=40, point_noise=0.3, seed=2)
    tg, _ = create_ba_scene(n_cameras=6, n_points=40, point_noise=0.3,
                            seed=2)
    vid = max(tg.vertices())
    jg.set_fixed(vid, True)
    tg.set_fixed(vid, True)
    jp, tp = jg.compile(), tg.compile(device="cpu")
    before = tp.get_estimate(vid)
    res = structure_only_refine(tp, n_iters=5)
    np.testing.assert_array_equal(tp.get_estimate(vid), before)
    _assert_same(tp, jp, res, j_refine(jp, n_iters=5))


def test_structure_only_requires_landmarks():
    tp = create_manhattan(n_poses=20, seed=1).compile(device="cpu")
    with pytest.raises(ValueError):
        structure_only_refine(tp)
    with pytest.raises(ValueError):
        j_refine(j_manhattan(n_poses=20, seed=1).compile())
