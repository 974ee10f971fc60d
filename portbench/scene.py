"""Synthetic BAL scenes at published sizes, drawn on the device.

The rules are those of an ill-conditioned capture: cameras on an arc
about 10 units from the cloud (yaw within +-0.4 rad, a slight tilt,
heights scattered by 0.4), focal lengths 800 (1 +- 5%), tiny radial terms;
log-normal point depths (median 8, sigma ``depth_sigma``, clipped to
[1.5, 60]) inside a ~30 degree cone, so every camera sees every point;
hub cameras (``hub_fraction`` of them) chosen ``hub_boost`` times as
often; track lengths 2 + Poisson(mean - 2) with distinct cameras per track
(Gumbel top-k over the camera weights, a block of points at a time);
pixel noise ``pixel_noise``; ``outlier_fraction`` of the observations
replaced by uniform garbage pixels in [-500, 500]^2.

Every seed gets the same work in another order: the scene (cameras,
points, tracks, hubs, pixel noise, which observations are garbage) is
drawn once from the configuration's ``structure_seed``, with the track
lengths summed to the published observation count exactly, and so is a
pool of job starts (the traffic's ``start_pool``); ``--seed`` draws the
order of the cameras, the points and the observations, and the order in
which a run cycles through the starts.  A start perturbs the true cameras
(rotation and translation) and points (a share of their depth).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.bal import Obs, project

POINTS_PER_BLOCK = 1 << 16


class Scene(NamedTuple):
    cams: torch.Tensor       # (C, 9) float64, the true cameras
    pts: torch.Tensor        # (P, 3) float64, the true points
    depth: torch.Tensor      # (P,) float64
    obs: Obs                 # float32 pixels
    track: torch.Tensor      # (P,) int64 observations per point
    cam_order: torch.Tensor  # (C,) the structure's camera at each index
    pt_order: torch.Tensor   # (P,) the structure's point at each index
    structure_seed: int
    seed: int


def generator(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def track_lengths(P, O, mean_extra, track_seed, max_len):
    """The fixed multiset of track lengths: 2 + Poisson(mean_extra),
    adjusted by one at random points until they sum to ``O``."""
    rng = np.random.default_rng(track_seed)
    k = 2 + rng.poisson(mean_extra, P)
    k = np.minimum(k, max_len)
    diff = O - int(k.sum())
    while diff:
        grow = diff > 0
        ok = np.flatnonzero(k < max_len if grow else k > 2)
        pick = rng.choice(ok, min(abs(diff), len(ok)), replace=False)
        k[pick] += 1 if grow else -1
        diff = O - int(k.sum())
    return k


def make_scene(cfg, seed, device):
    """The scene of configuration ``cfg`` for ``seed``."""
    C, P, O = cfg["cameras"], cfg["points"], cfg["observations"]
    s = cfg["scene"]
    dev = torch.device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    g = generator(s["structure_seed"], dev)

    def normal(*shape):
        return torch.randn(*shape, generator=g, **f64)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=g, **f64)

    # the structure: one per configuration
    cams = torch.zeros((C, 9), **f64)
    ang = 0.8 * (torch.arange(C, **f64) / max(C - 1, 1) - 0.5)
    cams[:, 1] = -ang
    cams[:, 0] = 0.05 * normal(C)
    cams[:, 3] = 2.0 * torch.sin(ang)
    cams[:, 4] = 0.4 * normal(C)
    cams[:, 5] = -10.0 + torch.cos(ang)
    cams[:, 6] = 800.0 * (1.0 + 0.05 * normal(C))
    cams[:, 7] = -1e-7 * (1.0 + 0.3 * normal(C))
    cams[:, 8] = 1e-13 * (1.0 + 0.3 * normal(C))

    depth = torch.exp(np.log(8.0) + s["depth_sigma"] * normal(P))
    depth = depth.clamp(1.5, 60.0)
    ux, uy = uniform(-0.45, 0.45, P), uniform(-0.35, 0.35, P)
    pts = torch.stack([ux * depth, uy * depth, 10.0 - depth], dim=1)

    logw = torch.zeros(C, **f64)
    hubs = torch.randperm(C, generator=g, device=dev)[
        :round(s["hub_fraction"] * C)]
    logw[hubs] = float(np.log(s["hub_boost"]))
    k = torch.as_tensor(track_lengths(P, O, O / P - 2.0,
                                      s["structure_seed"], C), device=dev)
    k = k[torch.randperm(P, generator=g, device=dev)]
    kmax = int(k.max())
    cam_idx, pt_idx = [], []
    for lo in range(0, P, POINTS_PER_BLOCK):
        kb = k[lo:lo + POINTS_PER_BLOCK]
        n = len(kb)
        u = torch.rand((n, C), generator=g, **f64).clamp_(1e-300, 1.0)
        keys = logw[None] - torch.log(-torch.log(u))
        sel = torch.topk(keys, kmax, dim=1).indices          # (n, kmax)
        keep = torch.arange(kmax, device=dev)[None] < kb[:, None]
        cam_idx.append(sel[keep])
        pt_idx.append((lo + torch.arange(n, device=dev))[:, None]
                      .expand(n, kmax)[keep])
    cam_idx, pt_idx = torch.cat(cam_idx), torch.cat(pt_idx)
    uv = project(cams[cam_idx], pts[pt_idx]) + s["pixel_noise"] * normal(O, 2)
    n_out = round(s["outlier_fraction"] * O)
    out = torch.randperm(O, generator=g, device=dev)[:n_out]
    uv[out] = uniform(-500.0, 500.0, n_out, 2)

    # the seed's draw: the order of the cameras, points and observations
    g = generator(seed, dev)
    cam_order = torch.randperm(C, generator=g, device=dev)
    pt_order = torch.randperm(P, generator=g, device=dev)
    obs_order = torch.randperm(O, generator=g, device=dev)
    cam_new = torch.argsort(cam_order)
    pt_new = torch.argsort(pt_order)
    obs = Obs(cam_new[cam_idx][obs_order], pt_new[pt_idx][obs_order],
              uv[obs_order].to(torch.float32))
    return Scene(cams[cam_order], pts[pt_order], depth[pt_order], obs,
                 k[pt_order], cam_order, pt_order, int(s["structure_seed"]),
                 int(seed))


def job_start(scene, traffic, job):
    """The start of job ``job`` (float32 cameras and points, in the scene's
    order): start ``job`` of the configuration's pool for the warm-up job
    (``job < 0``), else the pool's start at place ``job`` of the seed's
    cyclic order of it.  A start perturbs the true cameras and points."""
    dev = scene.cams.device
    pool = int(traffic["start_pool"])
    if job >= 0:
        order = torch.randperm(pool, generator=generator(scene.seed, "cpu"))
        job = int(order[job % pool])
    g = generator(scene.structure_seed * 1_000_003 + 7919 * (job + 2), dev)
    C, P = scene.cams.shape[0], scene.pts.shape[0]
    f64 = dict(dtype=torch.float64, device=dev)
    rot = traffic["rotation_sigma"] * torch.randn((C, 3), generator=g, **f64)
    trans = traffic["translation_sigma"] * torch.randn((C, 3), generator=g,
                                                       **f64)
    pt = torch.randn((P, 3), generator=g, **f64)
    cams = scene.cams.clone()
    cams[:, 0:3] += rot[scene.cam_order]
    cams[:, 3:6] += trans[scene.cam_order]
    pts = scene.pts + (traffic["point_sigma_per_depth"] * scene.depth)[
        :, None] * pt[scene.pt_order]
    return cams.to(torch.float32), pts.to(torch.float32)
