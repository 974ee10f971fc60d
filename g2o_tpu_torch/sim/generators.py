"""Synthetic graphs — port of ``create_sphere``, ``create_manhattan`` and
``create_ba_scene`` of ``g2o_tpu/sim/generators.py``.

``create_sphere`` (the reference generator is
``g2o/examples/sphere/create_sphere.cpp:40-231``): poses on a sphere,
odometry edges between consecutive poses, loop closures between laps,
Gaussian noise on the measurements (compact-quaternion rotation noise),
initial estimates chained from the noisy odometry.

Noise comes from a ``torch.Generator``; with zero noise the graph equals
the JAX package's.

``create_manhattan``: a 2D grid walk with 90-degree turns, odometry edges,
loop closures between revisits, noisy measurements and chained initial
estimates; it draws from ``np.random.default_rng(seed)`` in the JAX
package's order, so its graph is the JAX package's bit for bit.

``create_ba_scene`` (the reference's ``ba_demo.cpp``): cameras along a
line looking at a box of points, mono projection edges; also bit for bit
the JAX package's, with the visibility test and the noise draws made in
bulk.
"""

from __future__ import annotations

import numpy as np
import torch

from g2o_tpu_torch.core.graph import Graph


def _rotz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


def _roty(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1.0, 0], [-s, 0, c]])


def _quat_from_matrix(R):
    """(x, y, z, w) with w >= 0."""
    tr = np.trace(R)
    if tr > 0:
        w = np.sqrt(1.0 + tr) / 2.0
        x = (R[2, 1] - R[1, 2]) / (4 * w)
        y = (R[0, 2] - R[2, 0]) / (4 * w)
        z = (R[1, 0] - R[0, 1]) / (4 * w)
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 0.0)) * 2
        q = np.zeros(3)
        q[i] = s / 4
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        w = (R[k, j] - R[j, k]) / s
        x, y, z = q
    q = np.array([x, y, z, w])
    if q[3] < 0:
        q = -q
    return q / np.linalg.norm(q)


def _quat_to_matrix(q):
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _se3(R, t):
    return np.concatenate([t, _quat_from_matrix(R)])


def _se3_mul(a, b):
    Ra, Rb = _quat_to_matrix(a[3:]), _quat_to_matrix(b[3:])
    return _se3(Ra @ Rb, a[:3] + Ra @ b[:3])


def _se3_inv(a):
    R = _quat_to_matrix(a[3:]).T
    return _se3(R, -R @ a[:3])


def create_sphere(nodes_per_level: int = 50, laps: int = 50,
                  radius: float = 100.0,
                  trans_noise=(0.01, 0.01, 0.01),
                  rot_noise=(0.005, 0.005, 0.005),
                  generator: torch.Generator | None = None,
                  seed: int = 0) -> Graph:
    """The sphere pose graph; noise from ``generator`` (or a new one seeded
    with ``seed``).  Vertex 0 is fixed."""
    from g2o_tpu_torch.types.slam3d import EdgeSE3, VertexSE3

    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    n_total = nodes_per_level * laps

    gt = []
    vid = 0
    for f in range(laps):
        for n in range(nodes_per_level):
            vid += 1
            rot = _rotz(-np.pi + 2 * n * np.pi / nodes_per_level) @ \
                _roty(-0.5 * np.pi + vid * np.pi / n_total)
            gt.append(_se3(rot, rot @ np.array([radius, 0.0, 0.0])))

    pairs = [(i - 1, i) for i in range(1, n_total)]
    for f in range(1, laps):
        for nn in range(nodes_per_level):
            i = (f - 1) * nodes_per_level + nn
            for n in (-1, 0, 1):
                if f == laps - 1 and n == 1:
                    continue
                j = f * nodes_per_level + nn + n
                if 0 <= j < n_total:
                    pairs.append((i, j))

    info = np.zeros((6, 6))
    info[:3, :3] = np.diag(1.0 / np.square(trans_noise))
    info[3:, 3:] = np.diag(1.0 / np.square(rot_noise))

    # standard normals drawn in one batch, scaled per axis
    z = torch.randn((len(pairs), 2, 3), generator=generator,
                    dtype=torch.float64).numpy()
    qns = z[:, 0] * np.asarray(rot_noise)
    dts = z[:, 1] * np.asarray(trans_noise)
    measurements = []
    for (i, j), qn, dt in zip(pairs, qns, dts):
        t = _se3_mul(_se3_inv(gt[i]), gt[j])
        qw = max(1.0 - np.linalg.norm(qn), 0.0)
        dq = np.concatenate([qn, [qw]])
        dq /= np.linalg.norm(dq)
        measurements.append(_se3_mul(t, np.concatenate([dt, dq])))

    est = [gt[0]]
    for i in range(1, n_total):
        est.append(_se3_mul(est[i - 1], measurements[i - 1]))

    g = Graph()
    for i in range(n_total):
        g.add_vertex(i, VertexSE3, est[i], fixed=(i == 0))
    for (i, j), m in zip(pairs, measurements):
        g.add_edge(EdgeSE3, [i, j], m, info)
    return g


def create_manhattan(n_poses: int = 3500, step: float = 1.0,
                     trans_noise=(0.05, 0.05), rot_noise=0.02,
                     loop_radius: float = 1.5, max_loops_per_pose: int = 2,
                     seed: int = 0) -> Graph:
    from g2o_tpu_torch.types.slam2d import EdgeSE2, VertexSE2

    rng = np.random.default_rng(seed)

    def se2_mul(a, b):
        c, s = np.cos(a[2]), np.sin(a[2])
        th = a[2] + b[2]
        th = (th + np.pi) % (2 * np.pi) - np.pi
        return np.array([a[0] + c * b[0] - s * b[1],
                         a[1] + s * b[0] + c * b[1], th])

    def se2_inv(a):
        c, s = np.cos(a[2]), np.sin(a[2])
        return np.array([-(c * a[0] + s * a[1]), s * a[0] - c * a[1], -a[2]])

    # ground-truth random grid walk with 90-degree turns
    gt = [np.zeros(3)]
    heading = 0
    for _ in range(1, n_poses):
        r = rng.random()
        turn = 0 if r < 0.6 else 1 if r < 0.8 else -1
        heading = (heading + turn) % 4
        prev = gt[-1]
        th = heading * np.pi / 2
        gt.append(np.array([prev[0] + step * np.cos(th),
                            prev[1] + step * np.sin(th), th]))

    info = np.diag([1.0 / trans_noise[0] ** 2, 1.0 / trans_noise[1] ** 2,
                    1.0 / rot_noise ** 2])

    pairs = [(i - 1, i) for i in range(1, n_poses)]
    # loop closures: revisits within loop_radius (grid hashing for O(n))
    cell = {}
    for i, p in enumerate(gt):
        key = (int(np.floor(p[0] / loop_radius)),
               int(np.floor(p[1] / loop_radius)))
        cell.setdefault(key, []).append(i)
    for i, p in enumerate(gt):
        found = 0
        kx = int(np.floor(p[0] / loop_radius))
        ky = int(np.floor(p[1] / loop_radius))
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for j in cell.get((kx + dx, ky + dy), ()):
                    if j < i - 10 and found < max_loops_per_pose and \
                            np.linalg.norm(gt[i][:2] - gt[j][:2]) < \
                            loop_radius:
                        pairs.append((j, i))
                        found += 1

    measurements = []
    for (i, j) in pairs:
        t = se2_mul(se2_inv(gt[i]), gt[j])
        noise = np.array([rng.normal(scale=trans_noise[0]),
                          rng.normal(scale=trans_noise[1]),
                          rng.normal(scale=rot_noise)])
        measurements.append(se2_mul(t, noise))

    est = [gt[0]]
    for i in range(1, n_poses):
        est.append(se2_mul(est[i - 1], measurements[i - 1]))

    g = Graph()
    for i in range(n_poses):
        g.add_vertex(i, VertexSE2, est[i], fixed=(i == 0))
    for (i, j), m in zip(pairs, measurements):
        g.add_edge(EdgeSE2, [i, j], m, info)
    return g


def create_ba_scene(n_cameras: int = 15, n_points: int = 300,
                    focal: float = 1000.0, cx: float = 320.0, cy: float = 240.0,
                    pixel_noise: float = 1.0, outlier_ratio: float = 0.0,
                    point_noise: float = 1.0, seed: int = 0):
    """Synthetic mono BA problem (reference ``ba_demo.cpp``): cameras along a
    line looking at a box of points.  Returns ``(Graph, {point vid: true
    point})``.  Cameras 0 and 1 are fixed (gauge + scale); only points seen
    by at least two cameras are added, as in the reference, each with its
    observations in camera order."""
    from g2o_tpu_torch.types.sba import (CAM_PARAM_ID, EdgeProjectXYZ2UV,
                                         VertexPointXYZ, VertexSE3Expmap)

    rng = np.random.default_rng(seed)
    true_points = np.stack([
        rng.uniform(-3, 3, size=n_points),
        rng.uniform(-0.5, 0.5, size=n_points),
        rng.uniform(4, 8, size=n_points),
    ], axis=1)

    g = Graph()
    g.add_parameter(CAM_PARAM_ID, np.array([focal, cx, cy, 0.0]))
    # world-to-camera poses (Tcw): R = I, t = -C with C along x
    cam_t = np.stack([-np.array([i * 0.04 - 1.0, 0.0, 0.0])
                      for i in range(n_cameras)])
    for i in range(n_cameras):
        g.add_vertex(i, VertexSE3Expmap,
                     np.concatenate([cam_t[i], [0.0, 0.0, 0.0, 1.0]]),
                     fixed=(i < 2))

    # every (point, camera) projection at once; R = I, so R p + t = p + t
    pc = true_points[:, None, :] + cam_t[None, :, :]
    u = focal * pc[..., 0] / pc[..., 2] + cx
    v = focal * pc[..., 1] / pc[..., 2] + cy
    seen = ((pc[..., 2] > 0) & (u >= 0) & (u < 2 * cx)
            & (v >= 0) & (v < 2 * cy))
    kept = np.flatnonzero(seen.sum(axis=1) >= 2)

    if outlier_ratio > 0:
        # the outlier draws interleave uniform and normal draws per
        # observation: drawn one by one, in the JAX package's order
        init, obs = [], []
        for k in kept:
            init.append(true_points[k] + rng.normal(scale=point_noise,
                                                    size=3))
            for i in np.flatnonzero(seen[k]):
                if rng.random() < outlier_ratio:
                    obs.append(np.array([rng.uniform(0, 2 * cx),
                                         rng.uniform(0, 2 * cy)]))
                else:
                    obs.append(np.array([u[k, i], v[k, i]])
                               + rng.normal(scale=pixel_noise, size=2))
        init, obs = np.array(init), np.array(obs)
    else:
        # per kept point: 3 normals for its initial estimate, then 2 per
        # observation — one standard-normal stream, each draw scaled as
        # Generator.normal scales it (loc + scale * z)
        deg = seen[kept].sum(axis=1)
        z = rng.standard_normal(int(np.sum(3 + 2 * deg)))
        start = np.concatenate([[0], np.cumsum(3 + 2 * deg)[:-1]])
        pidx = start[:, None] + np.arange(3)
        init = true_points[kept] + (0.0 + point_noise * z[pidx])
        oidx = np.repeat(start + 3, deg) + 2 * (
            np.arange(int(deg.sum())) - np.repeat(np.cumsum(deg) - deg, deg))
        kk, ii = np.nonzero(seen[kept])
        obs = np.stack([u[kept[kk], ii], v[kept[kk], ii]], axis=1) + (
            0.0 + pixel_noise * z[oidx[:, None] + np.arange(2)])

    truth_by_vid = {}
    info = np.eye(2)
    n_obs = 0
    for j, k in enumerate(kept):
        vid = n_cameras + j
        g.add_vertex(vid, VertexPointXYZ, init[j], marginalized=True)
        truth_by_vid[vid] = true_points[k]
        for i in np.flatnonzero(seen[k]):
            g.add_edge(EdgeProjectXYZ2UV, [vid, int(i)], obs[n_obs], info,
                       param_id=CAM_PARAM_ID)
            n_obs += 1
    return g, truth_by_vid
