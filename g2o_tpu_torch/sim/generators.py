"""Synthetic sphere pose graph — port of
``g2o_tpu/sim/generators.py::create_sphere`` (the reference generator is
``g2o/examples/sphere/create_sphere.cpp:40-231``): poses on a sphere,
odometry edges between consecutive poses, loop closures between laps,
Gaussian noise on the measurements (compact-quaternion rotation noise),
initial estimates chained from the noisy odometry.

Noise comes from a ``torch.Generator``; with zero noise the graph equals
the JAX package's.
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
