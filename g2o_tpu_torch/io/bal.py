"""BAL dataset reader/writer and generators — port of ``g2o_tpu/io/bal.py``
(format: http://grail.cs.washington.edu/projects/bal/).

Format (as parsed by the reference ``bal_example.cpp:300-360``):

    num_cameras num_points num_observations
    <cam_idx point_idx u v>            x num_observations
    <9 camera params, one per line>    x num_cameras
    <3 point coords, one per line>     x num_points

Cameras get vertex ids [0, C); points [C, C+P) and are marked marginalized
for the Schur path (as the reference marks them, ``bal_example.cpp:420``).
The generators project through this package's own :func:`bal_project` on
the CPU in float64, so they write the same files as the JAX package's.
"""

from __future__ import annotations

import gzip
import os

import numpy as np
import torch

from g2o_tpu_torch.core.graph import Graph
from g2o_tpu_torch.core.problem import build_problem
from g2o_tpu_torch.ops import robust as robust_mod
from g2o_tpu_torch.types.bal import (EdgeObservationBAL, VertexCameraBAL,
                                     bal_project)
from g2o_tpu_torch.types.slam3d import VertexPointXYZ

# data/bal_cache of this repository
_REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "data", "bal_cache")


def _read_text(path_or_file):
    if hasattr(path_or_file, "read"):
        return path_or_file.read()
    with open(path_or_file) as fh:
        return fh.read()


def _parse(text):
    """BAL text -> (observations (O, 4), cameras (C, 9), points (P, 3))."""
    tokens = np.array(text.split(), dtype=np.float64)
    if len(tokens) < 3:
        raise ValueError("BAL file: missing the header line")
    C, P, O = int(tokens[0]), int(tokens[1]), int(tokens[2])
    need = 3 + 4 * O + 9 * C + 3 * P
    if len(tokens) < need:
        raise ValueError(f"BAL file: {len(tokens)} numbers, the header "
                         f"({C} cameras, {P} points, {O} observations) needs "
                         f"{need}")
    pos = 3
    obs = tokens[pos:pos + 4 * O].reshape(O, 4)
    pos += 4 * O
    cams = tokens[pos:pos + 9 * C].reshape(C, 9)
    pos += 9 * C
    pts = tokens[pos:pos + 3 * P].reshape(P, 3)
    return obs, cams, pts


def load_bal(path_or_file, *, fix_first_camera: bool = False,
             huber: float = 0.0) -> Graph:
    """A host :class:`Graph` of a BAL file.  ``fix_first_camera`` defaults
    to False, as the reference ``bal_example`` fixes NO camera (λ damping
    absorbs the 7-dof gauge)."""
    obs, cams, pts = _parse(_read_text(path_or_file))
    C, P = len(cams), len(pts)
    g = Graph()
    for i in range(C):
        g.add_vertex(i, VertexCameraBAL, cams[i],
                     fixed=(fix_first_camera and i == 0))
    for j in range(P):
        g.add_vertex(C + j, VertexPointXYZ, pts[j], marginalized=True)
    info = np.eye(2)
    kernel = "Huber" if huber > 0 else None
    for o in obs:
        g.add_edge(EdgeObservationBAL, [int(o[0]), C + int(o[1])], o[2:4],
                   info, kernel=kernel, delta=huber if huber > 0 else 1.0)
    return g


def load_bal_problem(path_or_file, *, fix_first_camera: bool = False,
                     huber: float = 0.0, dtype=None, device="cuda",
                     pad_edges_to_multiple: int = 1,
                     bucket_landmarks: bool = False):
    """Array-direct BAL loading: text -> numpy blocks ->
    :func:`~g2o_tpu_torch.core.problem.build_problem`, without per-record
    Python objects.  The problem is built on ``device`` (the CUDA card
    unless the caller passes ``"cpu"``); ``bucket_landmarks=True`` gives
    the landmark-bucketed layout of the implicit Schur solver (points
    reordered into bucket order)."""
    obs, cams, pts = _parse(_read_text(path_or_file))
    C, P, O = len(cams), len(pts), len(obs)
    cam_fixed = np.zeros(C, dtype=bool)
    if fix_first_camera:
        cam_fixed[0] = True
    vertex_blocks = {
        VertexCameraBAL.name: (np.arange(C, dtype=np.int64), cams, cam_fixed,
                               np.zeros(C, dtype=bool)),
        VertexPointXYZ.name: (C + np.arange(P, dtype=np.int64), pts,
                              np.zeros(P, dtype=bool), np.ones(P, dtype=bool)),
    }
    vids = np.stack([obs[:, 0].astype(np.int64),
                     C + obs[:, 1].astype(np.int64)], axis=1)
    kid = robust_mod.HUBER if huber > 0 else robust_mod.NONE
    edge_blocks = {
        EdgeObservationBAL.name: (
            vids, obs[:, 2:4],
            np.tile(np.eye(2), (O, 1, 1)),
            np.full(O, kid, dtype=np.int64),
            np.full(O, huber if huber > 0 else 1.0),
            np.ones(O, dtype=bool),
            np.zeros((O, 0)),
        )
    }
    return build_problem(vertex_blocks, edge_blocks, dtype=dtype,
                         device=device,
                         pad_edges_to_multiple=pad_edges_to_multiple,
                         bucket_landmarks=bucket_landmarks)


def save_bal(g: Graph, path, estimates_by_vid=None):
    """Write the graph back in BAL format (cameras/points recovered by
    type)."""
    est = estimates_by_vid or {vid: r.estimate
                               for vid, r in g.vertices().items()}
    cams = sorted(vid for vid, r in g.vertices().items()
                  if r.vtype is VertexCameraBAL)
    pts = sorted(vid for vid, r in g.vertices().items()
                 if r.vtype is not VertexCameraBAL)
    cam_index = {vid: i for i, vid in enumerate(cams)}
    pt_index = {vid: i for i, vid in enumerate(pts)}
    lines = [f"{len(cams)} {len(pts)} {len(g.edges())}"]
    for e in g.edges():
        ci, pi = e.vids
        lines.append(f"{cam_index[ci]} {pt_index[pi]} "
                     f"{e.measurement[0]:.12g} {e.measurement[1]:.12g}")
    for vid in cams:
        lines.extend(f"{v:.16g}" for v in np.asarray(est[vid]))
    for vid in pts:
        lines.extend(f"{v:.16g}" for v in np.asarray(est[vid]))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def _project_np(cams, pts):
    """:func:`bal_project` on the CPU in float64, numpy in and out."""
    return bal_project(torch.as_tensor(cams, dtype=torch.float64),
                       torch.as_tensor(pts, dtype=torch.float64)).numpy()


def _cached(fname, make, cache_dir):
    """The gzip text ``fname`` from ``cache_dir`` or this repository's
    ``data/bal_cache``; else ``make()``, written to the first of those that
    takes it."""
    dirs = ([cache_dir] if cache_dir else []) + [_REPO_CACHE]
    for d in dirs:
        path = os.path.join(d, fname)
        if os.path.exists(path):
            with gzip.open(path, "rt") as fh:
                return fh.read()
    text = make()
    for d in dirs:
        try:
            os.makedirs(d, exist_ok=True)
            with gzip.open(os.path.join(d, fname), "wt") as fh:
                fh.write(text)
            break
        except OSError:
            continue
    return text


def synthetic_bal_cached(n_cameras=49, n_points=7000, n_obs_per_point=6,
                         pixel_noise=1.0, seed=0, cache_dir=None):
    """Text of :func:`make_synthetic_bal`, disk-cached (gzip) under the
    JAX package's file name, so both packages read the committed
    ``data/bal_cache/`` files."""
    fname = (f"bal-C{n_cameras}-P{n_points}-K{n_obs_per_point}"
             f"-N{pixel_noise:g}-S{seed}.txt.gz")
    return _cached(fname, lambda: make_synthetic_bal(
        n_cameras=n_cameras, n_points=n_points,
        n_obs_per_point=n_obs_per_point, pixel_noise=pixel_noise,
        seed=seed), cache_dir)


def stress_bal_cached(cache_dir=None, **kw):
    """Disk-cached :func:`make_stress_bal` text (see
    :func:`synthetic_bal_cached`)."""
    defaults = dict(n_cameras=120, n_points=30_000, mean_obs_per_point=6,
                    depth_sigma=0.8, hub_fraction=0.1, hub_boost=10.0,
                    outlier_fraction=0.07, pixel_noise=1.0,
                    estimate_noise=True, seed=0)
    defaults.update(kw)
    key = "-".join(f"{k}{v:g}" if isinstance(v, (int, float)) else f"{k}{v}"
                   for k, v in sorted(defaults.items()))
    return _cached(f"balstress-{key}.txt.gz",
                   lambda: make_stress_bal(**defaults), cache_dir)


def make_stress_bal(n_cameras=120, n_points=30_000, mean_obs_per_point=6,
                    depth_sigma=0.8, hub_fraction=0.1, hub_boost=10.0,
                    outlier_fraction=0.07, pixel_noise=1.0,
                    estimate_noise=True, seed=0):
    """Ill-conditioned synthetic BAL problem, with the pathologies of real
    captures: log-normal point depths (a wide Schur spectrum), hub cameras
    (``hub_fraction`` of cameras with ``hub_boost``x selection weight,
    Gumbel top-k sampling without replacement), track lengths
    2 + Poisson(mean-2), ``outlier_fraction`` of observations replaced by
    uniform garbage pixels, noisy intrinsics and perturbed stored estimates.
    Observations come from the TRUE geometry + noise; the stored values are
    the perturbed ones."""
    rng = np.random.default_rng(seed)
    C, P = n_cameras, n_points

    # ground-truth cameras on two stacked arcs ~10 units from the cloud
    cams = np.zeros((C, 9))
    ang = 0.8 * (np.arange(C) / max(C - 1, 1) - 0.5)
    cams[:, 1] = -ang                                   # yaw about y
    cams[:, 0] = 0.05 * rng.standard_normal(C)          # slight tilt
    cams[:, 3] = 2.0 * np.sin(ang)
    cams[:, 4] = 0.4 * rng.standard_normal(C)
    cams[:, 5] = -10.0 + np.cos(ang)
    cams[:, 6] = 800.0 * (1.0 + 0.05 * rng.standard_normal(C))
    cams[:, 7] = -1e-7 * (1.0 + 0.3 * rng.standard_normal(C))
    cams[:, 8] = 1e-13 * (1.0 + 0.3 * rng.standard_normal(C))

    # log-normal depths; lateral position within a ~30deg cone so every
    # camera sees every point (bounded |proj|)
    depth = np.exp(rng.normal(np.log(8.0), depth_sigma, P))
    depth = np.clip(depth, 1.5, 60.0)
    ux = rng.uniform(-0.45, 0.45, P)
    uy = rng.uniform(-0.35, 0.35, P)
    pts = np.stack([ux * depth, uy * depth, 10.0 - depth], axis=1)

    # weighted track sampling: hub cameras get hub_boost x weight
    w = np.ones(C)
    w[rng.random(C) < hub_fraction] = hub_boost
    k_per_pt = 2 + rng.poisson(max(mean_obs_per_point - 2, 0), P)
    k_per_pt = np.minimum(k_per_pt, C)
    kmax = int(k_per_pt.max())
    gumbel = rng.gumbel(size=(P, C))
    keys = np.log(w)[None, :] + gumbel
    sel = np.argsort(-keys, axis=1)[:, :kmax]           # (P, kmax)
    row_mask = np.arange(kmax)[None, :] < k_per_pt[:, None]
    pt_idx = np.repeat(np.arange(P), kmax)[row_mask.ravel()]
    cam_idx = sel.ravel()[row_mask.ravel()]

    uv = _project_np(cams[cam_idx], pts[pt_idx])
    uv = uv + rng.normal(scale=pixel_noise, size=uv.shape)
    out_mask = rng.random(len(uv)) < outlier_fraction
    uv[out_mask] = rng.uniform(-500.0, 500.0, (int(out_mask.sum()), 2))

    # perturbed stored estimates (the file's initial values)
    cams_store = cams.copy()
    pts_store = pts.copy()
    if estimate_noise:
        cams_store[:, :3] += 0.005 * rng.standard_normal((C, 3))
        cams_store[:, 3:6] += 0.05 * rng.standard_normal((C, 3))
        pts_store += (0.02 * depth)[:, None] * rng.standard_normal((P, 3))

    lines = [f"{C} {P} {len(uv)}"]
    lines += [f"{c} {j} {u:.6f} {v:.6f}"
              for c, j, (u, v) in zip(cam_idx.tolist(), pt_idx.tolist(), uv)]
    for i in range(C):
        lines += [f"{v:.16g}" for v in cams_store[i]]
    for j in range(P):
        lines += [f"{v:.16g}" for v in pts_store[j]]
    return "\n".join(lines) + "\n"


def make_synthetic_bal(n_cameras=49, n_points=7000, n_obs_per_point=6,
                       pixel_noise=1.0, seed=0):
    """Ladybug-like synthetic BAL problem: cameras on an arc looking inward
    at a point cloud."""
    rng = np.random.default_rng(seed)
    cams = np.zeros((n_cameras, 9))
    for i in range(n_cameras):
        ang = 0.6 * (i / max(n_cameras - 1, 1) - 0.5)
        # camera at radius 10 on an arc in the x-z plane, looking at origin:
        # rotation about y by -ang maps world to camera (approximately)
        cams[i, :3] = [0.0, -ang, 0.0]
        cams[i, 3:6] = [10 * np.sin(ang) * 0.2, 0.0, -10.0 + np.cos(ang)]
        cams[i, 6] = 800.0 + rng.normal() * 5
        cams[i, 7] = -1e-7
        cams[i, 8] = 1e-13
    pts = np.stack([
        rng.uniform(-4, 4, n_points),
        rng.uniform(-3, 3, n_points),
        rng.uniform(-2, 2, n_points),
    ], axis=1)

    # k distinct cameras per point via random-key argsort, then one batched
    # projection
    k = min(n_obs_per_point, n_cameras)
    keys = rng.random((n_points, n_cameras))
    sel = np.argsort(keys, axis=1)[:, :k]                      # (P, k)
    uv = _project_np(cams[sel.reshape(-1)], np.repeat(pts, k, axis=0))
    uv = uv + rng.normal(scale=pixel_noise, size=uv.shape)
    pt_idx = np.repeat(np.arange(n_points), k)
    obs = list(zip(sel.reshape(-1).tolist(), pt_idx.tolist(),
                   uv[:, 0].tolist(), uv[:, 1].tolist()))

    lines = [f"{n_cameras} {n_points} {len(obs)}"]
    lines += [f"{c} {j} {u:.6f} {v:.6f}" for c, j, u, v in obs]
    for i in range(n_cameras):
        lines += [f"{v:.16g}" for v in cams[i]]
    for j in range(n_points):
        lines += [f"{v:.16g}" for v in pts[j]]
    return "\n".join(lines) + "\n"
