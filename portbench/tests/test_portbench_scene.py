"""The frozen scene generator: deterministic in the seed, the published
counts, and the rules at small sizes."""

import pytest
import torch

from portbench import scene as scene_mod
from portbench.reference.bal import project

SMALL = dict(cameras=50, points=5000, observations=25163)


def _cfg(**over):
    cfg = dict(SMALL, scene=dict(depth_sigma=0.8, hub_fraction=0.1,
                                 hub_boost=10.0, outlier_fraction=0.07,
                                 pixel_noise=1.0, structure_seed=0))
    cfg.update(over)
    return cfg


@pytest.fixture(scope="module")
def scene():
    return scene_mod.make_scene(_cfg(), 2 ** 31 + 99, "cpu")


def test_deterministic_in_the_seed(scene):
    again = scene_mod.make_scene(_cfg(), 2 ** 31 + 99, "cpu")
    other = scene_mod.make_scene(_cfg(), 2 ** 31 + 100, "cpu")
    for a, b in zip(scene.obs, again.obs):
        assert torch.equal(a, b)
    assert torch.equal(scene.cams, again.cams)
    assert not torch.equal(scene.obs.uv, other.obs.uv)
    # the same pixels, in another order
    assert torch.equal(torch.sort(scene.obs.uv[:, 0]).values,
                       torch.sort(other.obs.uv[:, 0]).values)
    # every seed has the same structure, in another order
    assert torch.equal(torch.sort(scene.track).values,
                       torch.sort(other.track).values)
    per_cam = [torch.sort(torch.bincount(s.obs.cam)).values
               for s in (scene, other)]
    assert torch.equal(*per_cam)
    assert torch.equal(torch.sort(scene.depth).values,
                       torch.sort(other.depth).values)
    t = dict(rotation_sigma=0.005, translation_sigma=0.05,
             point_sigma_per_depth=0.02, start_pool=4)
    s0 = scene_mod.job_start(scene, t, 3)
    assert all(torch.equal(a, b)
               for a, b in zip(s0, scene_mod.job_start(scene, t, 3)))
    assert not torch.equal(s0[1], scene_mod.job_start(scene, t, 2)[1])
    # a run cycles through the pool: job 7 starts where job 3 did
    assert torch.equal(s0[1], scene_mod.job_start(scene, t, 7)[1])
    # every seed draws the same pool of starts, in its own order
    pool = {tuple(torch.sort(scene_mod.job_start(s, t, j)[1].flatten())
                  .values[:5].tolist()) for s in (scene, other)
            for j in range(4)}
    assert len(pool) == 4


def test_published_counts_and_distinct_cameras(scene):
    C, P, O = SMALL["cameras"], SMALL["points"], SMALL["observations"]
    assert len(scene.obs.cam) == O == int(scene.track.sum())
    assert scene.cams.shape == (C, 9) and scene.pts.shape == (P, 3)
    assert int(scene.track.min()) >= 2
    pairs = scene.obs.pt * C + scene.obs.cam
    assert len(torch.unique(pairs)) == O          # no camera twice a track
    assert torch.equal(torch.bincount(scene.obs.pt, minlength=P),
                       scene.track)


def test_track_hub_and_outlier_rules(scene):
    C, O = SMALL["cameras"], SMALL["observations"]
    k = scene.track.double()
    assert abs(float(k.mean()) - O / SMALL["points"]) < 1e-9
    # 2 + Poisson(mean - 2): the variance of a Poisson is its mean
    assert abs(float(k.var()) - (float(k.mean()) - 2)) < 0.25
    per_cam = torch.bincount(scene.obs.cam, minlength=C).double()
    top = torch.sort(per_cam, descending=True).values
    hubs = round(0.1 * C)
    # hubs are chosen 10x as often, without replacement within a track
    assert float(top[:hubs].mean()) > 4 * float(top[hubs:].mean())
    err = (scene.obs.uv.double() - project(scene.cams[scene.obs.cam],
                                           scene.pts[scene.obs.pt]))
    far = (err.abs().max(dim=1).values > 30).double().mean()
    assert 0.06 < float(far) <= 0.07 + 1e-9
    inlier = err[err.abs().max(dim=1).values < 5]
    assert abs(float(inlier.std()) - 1.0) < 0.05
