"""Synthetic graphs — port of ``create_sphere``, ``create_manhattan``,
``create_simulator2d``, ``create_simulator3d`` and ``create_ba_scene`` of
``g2o_tpu/sim/generators.py``.

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

``create_simulator2d`` / ``create_simulator3d`` (the reference's
``g2o_simulator`` apps): a random-walk trajectory observing landmarks,
segments, lines and planes with nine pluggable sensors each; they draw
from ``np.random.default_rng(seed)`` in the JAX package's order, with the
same vertex ids, parameter ids and edge order, so their graphs are the
JAX package's bit for bit.

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


def create_simulator2d(n_poses: int = 200, n_landmarks: int = 60,
                       world_size: float = 20.0,
                       sensors=("odometry", "pointxy", "bearing"),
                       sensor_range: float = 5.0,
                       trans_noise=(0.03, 0.03), rot_noise=0.01,
                       landmark_noise=(0.05, 0.05),
                       bearing_noise: float = 0.01,
                       n_segments: int = 20, n_lines: int = 12,
                       segment_noise: float = 0.03,
                       line_noise=(0.01, 0.03),
                       sensor_offset=(0.15, 0.1, 0.2),
                       noise_scale: float = 1.0,
                       seed: int = 0) -> Graph:
    """2D simulator with pluggable sensors — analogue of the reference
    ``g2o_simulator`` 2D app (``apps/g2o_simulator/test_simulator2d.cpp:40``
    and the sensor library under ``apps/g2o_simulator/sensor_*2d*``):
    a random-walk trajectory observing scattered XY landmarks, segments and
    lines with range-limited sensors, all measurements noisy.

    Sensors (reference counterparts in parentheses):

    * ``"odometry"``          — consecutive SE2 edges (SensorOdometry2D)
    * ``"pose"``              — SE2 edges to spatially-close earlier poses
                                (SensorPose2D)
    * ``"pointxy"``           — XY landmark observations (SensorPointXY)
    * ``"bearing"``           — bearing-only observations
                                (SensorPointXYBearing)
    * ``"pointxy_offset"``    — XY observation through a calibrated SE2
                                sensor offset parameter
                                (SensorPointXYOffset)
    * ``"segment"``           — both endpoints of a world segment in the
                                observing frame (SensorSegment2D)
    * ``"segment_line"``      — supporting line (θ, ρ) of the segment
                                (SensorSegment2DLine)
    * ``"segment_pointline"`` — one visible endpoint + line direction
                                (SensorSegment2DPointLine)
    * ``"line2d"``            — (θ, ρ) line landmarks (EdgeSE2Line2D)

    ``noise_scale=0`` yields a zero-noise graph whose chi2 at the returned
    estimates is exactly 0 (measurement-model consistency check).
    """
    from g2o_tpu_torch.types.slam2d import (
        EdgeSE2, EdgeSE2PointXY, EdgeSE2PointXYBearing, EdgeSE2PointXYOffset,
        VertexSE2, VertexPointXY,
    )
    from g2o_tpu_torch.types.slam2d_addons import (
        EdgeSE2Line2D, EdgeSE2Segment2D, EdgeSE2Segment2DLine,
        EdgeSE2Segment2DPointLine, EdgeSE2Segment2DPointLine1,
        VertexLine2D, VertexSegment2D,
    )

    rng = np.random.default_rng(seed)

    def se2_mul(a, b):
        c, s = np.cos(a[2]), np.sin(a[2])
        th = (a[2] + b[2] + np.pi) % (2 * np.pi) - np.pi
        return np.array([a[0] + c * b[0] - s * b[1],
                         a[1] + s * b[0] + c * b[1], th])

    def se2_inv(a):
        c, s = np.cos(a[2]), np.sin(a[2])
        return np.array([-(c * a[0] + s * a[1]), s * a[0] - c * a[1], -a[2]])

    def nrm(scale, size=None):
        return noise_scale * rng.normal(scale=scale, size=size)

    landmarks = rng.uniform(-world_size / 2, world_size / 2,
                            size=(n_landmarks, 2))
    gt = [np.zeros(3)]
    for _ in range(1, n_poses):
        step = np.array([0.5 + 0.3 * rng.random(), 0.0,
                         rng.normal(scale=0.3)])
        nxt = se2_mul(gt[-1], step)
        if np.abs(nxt[:2]).max() > world_size / 2:
            step[2] = np.pi / 2
            nxt = se2_mul(gt[-1], step)
        gt.append(nxt)

    g = Graph()
    info_odo = np.diag([1.0 / trans_noise[0] ** 2, 1.0 / trans_noise[1] ** 2,
                        1.0 / rot_noise ** 2])
    info_lm = np.diag([1.0 / landmark_noise[0] ** 2,
                       1.0 / landmark_noise[1] ** 2])
    info_bearing = np.array([[1.0 / bearing_noise ** 2]])

    for i, p in enumerate(gt):
        g.add_vertex(i, VertexSE2, p, fixed=(i == 0))
    seen = set()
    lm_vid0 = n_poses
    if "odometry" in sensors:
        for i in range(1, n_poses):
            t = se2_mul(se2_inv(gt[i - 1]), gt[i])
            noise = np.array([nrm(trans_noise[0]), nrm(trans_noise[1]),
                              nrm(rot_noise)])
            g.add_edge(EdgeSE2, [i - 1, i], se2_mul(t, noise), info_odo)
    if "pose" in sensors:
        # SensorPose2D: SE2 observation of spatially-close EARLIER poses
        cell2 = {}
        for i, p in enumerate(gt):
            key = (int(np.floor(p[0] / sensor_range)),
                   int(np.floor(p[1] / sensor_range)))
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    for j in cell2.get((key[0] + dx, key[1] + dy), ()):
                        if j < i - 8 and np.linalg.norm(
                                gt[i][:2] - gt[j][:2]) < sensor_range / 2:
                            t = se2_mul(se2_inv(gt[j]), gt[i])
                            noise = np.array([nrm(trans_noise[0]),
                                              nrm(trans_noise[1]),
                                              nrm(rot_noise)])
                            g.add_edge(EdgeSE2, [j, i], se2_mul(t, noise),
                                       info_odo)
            cell2.setdefault(key, []).append(i)
    off_pid = None
    if "pointxy_offset" in sensors:
        off_pid = 100000
        g.add_parameter(off_pid, np.asarray(sensor_offset, dtype=float))
    for i, p in enumerate(gt):
        rel_all = landmarks - p[:2]
        dists = np.linalg.norm(rel_all, axis=1)
        c, s = np.cos(p[2]), np.sin(p[2])
        for k in np.nonzero(dists < sensor_range)[0]:
            vid = lm_vid0 + int(k)
            local = np.array([c * rel_all[k][0] + s * rel_all[k][1],
                              -s * rel_all[k][0] + c * rel_all[k][1]])
            if vid not in seen:
                obs = local + nrm(landmark_noise)
                world = p[:2] + np.array([c * obs[0] - s * obs[1],
                                          s * obs[0] + c * obs[1]])
                g.add_vertex(vid, VertexPointXY, world)
                seen.add(vid)
            if "pointxy" in sensors:
                obs = local + nrm(landmark_noise)
                g.add_edge(EdgeSE2PointXY, [i, vid], obs, info_lm)
            if "bearing" in sensors:
                b = np.arctan2(local[1], local[0]) + nrm(bearing_noise)
                g.add_edge(EdgeSE2PointXYBearing, [i, vid], [b], info_bearing)
            if "pointxy_offset" in sensors:
                # observation in the OFFSET sensor frame: (x∘O)^-1 * l
                sf = se2_mul(p, np.asarray(sensor_offset, dtype=float))
                ci, si = np.cos(sf[2]), np.sin(sf[2])
                rel = landmarks[k] - sf[:2]
                obs = np.array([ci * rel[0] + si * rel[1],
                                -si * rel[0] + ci * rel[1]]) \
                    + nrm(landmark_noise)
                g.add_edge(EdgeSE2PointXYOffset, [i, vid], obs, info_lm,
                           param_id=off_pid)

    # ---- segment sensors (SensorSegment2D{,Line,PointLine}) ---- #
    want_segments = {"segment", "segment_line", "segment_pointline"} \
        & set(sensors)
    if want_segments:
        seg_vid0 = lm_vid0 + n_landmarks
        centers = rng.uniform(-world_size / 2, world_size / 2,
                              size=(n_segments, 2))
        angles = rng.uniform(-np.pi, np.pi, size=n_segments)
        lengths = rng.uniform(1.0, 3.0, size=n_segments)
        segs = np.concatenate([
            centers - 0.5 * lengths[:, None] * np.stack(
                [np.cos(angles), np.sin(angles)], axis=1),
            centers + 0.5 * lengths[:, None] * np.stack(
                [np.cos(angles), np.sin(angles)], axis=1)], axis=1)
        info_seg = np.eye(4) / segment_noise ** 2
        info_segline = np.diag([1.0 / line_noise[0] ** 2,
                                1.0 / line_noise[1] ** 2])
        info_pl = np.diag([1.0 / segment_noise ** 2,
                           1.0 / segment_noise ** 2,
                           1.0 / line_noise[0] ** 2])
        seg_seen = set()

        def seg_local(p, sg):
            inv = se2_inv(p)
            ci, si = np.cos(inv[2]), np.sin(inv[2])
            out = []
            for e0 in (sg[0:2], sg[2:4]):
                out.append(np.array([
                    ci * e0[0] - si * e0[1] + inv[0],
                    si * e0[0] + ci * e0[1] + inv[1]]))
            return np.concatenate(out)

        for i, p in enumerate(gt):
            mids = 0.5 * (segs[:, :2] + segs[:, 2:])
            dists = np.linalg.norm(mids - p[:2], axis=1)
            for k in np.nonzero(dists < sensor_range)[0]:
                vid = seg_vid0 + int(k)
                if vid not in seen and vid not in seg_seen:
                    init = segs[k] + nrm(segment_noise, size=4)
                    g.add_vertex(vid, VertexSegment2D, init)
                    seg_seen.add(vid)
                loc = seg_local(p, segs[k])
                if "segment" in sensors:
                    g.add_edge(EdgeSE2Segment2D, [i, vid],
                               loc + nrm(segment_noise, size=4), info_seg)
                if "segment_line" in sensors or \
                        "segment_pointline" in sensors:
                    dp = loc[2:] - loc[:2]
                    n = np.array([dp[1], -dp[0]])
                    n /= np.linalg.norm(n)
                    theta = np.arctan2(n[1], n[0])
                    rho = 0.5 * (loc[:2] @ n + loc[2:] @ n)
                    if "segment_line" in sensors:
                        m = np.array([theta + nrm(line_noise[0]),
                                      rho + nrm(line_noise[1])])
                        g.add_edge(EdgeSE2Segment2DLine, [i, vid], m,
                                   info_segline)
                    if "segment_pointline" in sensors:
                        pn = int(rng.random() < 0.5)
                        pt = loc[0:2] if pn == 0 else loc[2:4]
                        m = np.concatenate([
                            pt + nrm(segment_noise, size=2),
                            [theta + nrm(line_noise[0])]])
                        et = (EdgeSE2Segment2DPointLine if pn == 0
                              else EdgeSE2Segment2DPointLine1)
                        g.add_edge(et, [i, vid], m, info_pl)

    # ---- (θ, ρ) line landmarks (EdgeSE2Line2D) ---- #
    if "line2d" in sensors:
        line_vid0 = lm_vid0 + n_landmarks + \
            (n_segments if want_segments else 0)
        thetas = rng.uniform(-np.pi, np.pi, size=n_lines)
        rhos = rng.uniform(0.0, world_size / 2, size=n_lines)
        info_line = np.diag([1.0 / line_noise[0] ** 2,
                             1.0 / line_noise[1] ** 2])
        line_seen = set()
        for i, p in enumerate(gt):
            inv = se2_inv(p)
            for k in range(n_lines):
                # observed when the foot of the perpendicular is in range
                foot = rhos[k] * np.array([np.cos(thetas[k]),
                                           np.sin(thetas[k])])
                if np.linalg.norm(foot - p[:2]) >= sensor_range:
                    continue
                th_l = _wrap(thetas[k] + inv[2])
                n = np.array([np.cos(th_l), np.sin(th_l)])
                rho_l = rhos[k] + n @ inv[:2]
                vid = line_vid0 + k
                if vid not in line_seen:
                    init = np.array([_wrap(thetas[k] + nrm(line_noise[0])),
                                     rhos[k] + nrm(line_noise[1]),
                                     -1.0, -1.0])
                    g.add_vertex(vid, VertexLine2D, init)
                    line_seen.add(vid)
                m = np.array([_wrap(th_l + nrm(line_noise[0])),
                              rho_l + nrm(line_noise[1])])
                g.add_edge(EdgeSE2Line2D, [i, vid], m, info_line)
    return g


def _wrap(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def create_simulator3d(n_poses: int = 100, n_landmarks: int = 80,
                       world_size: float = 15.0, sensor_range: float = 6.0,
                       sensors=("odometry", "trackxyz"),
                       trans_noise=(0.02, 0.02, 0.02),
                       rot_noise=(0.005, 0.005, 0.005),
                       landmark_noise=(0.03, 0.03, 0.03),
                       n_lines: int = 12, n_planes: int = 8,
                       pixel_noise: float = 1.0, depth_noise: float = 0.02,
                       line_noise: float = 0.005, plane_noise: float = 0.005,
                       focal: float = 300.0, cx: float = 160.0,
                       cy: float = 120.0,
                       noise_scale: float = 1.0,
                       seed: int = 0) -> Graph:
    """3D simulator with pluggable sensors — analogue of the 3D simulator
    app (``apps/g2o_simulator/test_simulator3d.cpp`` and the 3D sensor
    library ``apps/g2o_simulator/sensor_*3d*``).

    Sensors (reference counterparts in parentheses):

    * ``"odometry"``  — consecutive SE3 edges (SensorOdometry3D)
    * ``"pose"``      — SE3 edges to spatially-close earlier poses
                        (SensorPose3D)
    * ``"pose_offset"`` — EDGE_SE3_OFFSET edges to close earlier poses
                        through two SE3 offset params (SensorPose3DOffset)
    * ``"se3prior"``  — unary EDGE_SE3_PRIOR global pose measurements
                        through an SE3 offset param (SensorSE3Prior)
    * ``"trackxyz"``  — XYZ landmark observations through an SE3 offset
                        parameter (SensorPointXYZ / EDGE_SE3_TRACKXYZ)
    * ``"depth"``     — [u/w, v/w, z] camera observations
                        (SensorPointXYZDepth / EDGE_PROJECT_DEPTH)
    * ``"disparity"`` — [u/w, v/w, 1/z] camera observations
                        (SensorPointXYZDisparity / EDGE_PROJECT_DISPARITY)
    * ``"line3d"``    — Plücker line landmarks in the observing frame
                        (SensorSE3Line / EDGE_SE3_LINE3D)
    * ``"plane"``     — plane landmarks through a calibration offset vertex
                        (SensorPlane3D / EDGE_SE3_PLANE_CALIB)

    ``noise_scale=0`` yields a zero-noise graph with chi2 exactly 0 at the
    returned estimates (measurement-model consistency check)."""
    from g2o_tpu_torch.types.slam3d import (
        EdgeSE3, EdgeSE3Offset, EdgeSE3PointXYZ, EdgeSE3PointXYZDepth,
        EdgeSE3PointXYZDisparity, EdgeSE3Prior, VertexSE3, VertexPointXYZ,
    )
    from g2o_tpu_torch.types.slam3d_addons import (
        EdgeSE3Line3D, EdgeSE3PlaneCalib, VertexLine3D, VertexPlane,
    )

    rng = np.random.default_rng(seed)

    def nrm(scale, size=None):
        return noise_scale * rng.normal(scale=scale, size=size)

    def noisy_se3(t):
        qn = nrm(rot_noise)
        qw = max(1.0 - np.linalg.norm(qn), 0.0)
        dq = np.concatenate([qn, [qw]])
        dq /= np.linalg.norm(dq)
        return _se3_mul(t, np.concatenate([nrm(trans_noise), dq]))

    def small_rot(scale):
        ax = rng.normal(size=3)
        ax /= np.linalg.norm(ax)
        a = nrm(scale)
        q = np.concatenate([np.sin(a / 2) * ax, [np.cos(a / 2)]])
        return _quat_to_matrix(q)

    landmarks = rng.uniform(-world_size / 2, world_size / 2,
                            size=(n_landmarks, 3))

    gt = [np.array([0, 0, 0, 0, 0, 0, 1.0])]
    for i in range(1, n_poses):
        ax = rng.normal(size=3)
        ax /= np.linalg.norm(ax)
        ang = rng.normal(scale=0.15)
        q = np.concatenate([np.sin(ang / 2) * ax, [np.cos(ang / 2)]])
        step = np.concatenate([[0.6, 0, 0], q])
        nxt = _se3_mul(gt[-1], step)
        if np.abs(nxt[:3]).max() > world_size / 2:
            turn = _se3(_rotz(np.pi / 2), np.zeros(3))
            nxt = _se3_mul(gt[-1], turn)
        gt.append(nxt)

    g = Graph()
    g.add_parameter(0, np.array([0, 0, 0, 0, 0, 0, 1.0]))  # identity offset
    info_odo = np.zeros((6, 6))
    info_odo[:3, :3] = np.diag(1.0 / np.square(trans_noise))
    info_odo[3:, 3:] = np.diag(1.0 / np.square(rot_noise))
    info_lm = np.diag(1.0 / np.square(landmark_noise))

    for i, p in enumerate(gt):
        g.add_vertex(i, VertexSE3, p, fixed=(i == 0))
    if "odometry" in sensors:
        for i in range(1, n_poses):
            t = _se3_mul(_se3_inv(gt[i - 1]), gt[i])
            g.add_edge(EdgeSE3, [i - 1, i], noisy_se3(t), info_odo)
    if "pose" in sensors:
        # SensorPose3D: SE3 observation of spatially-close earlier poses
        for i in range(n_poses):
            for j in range(i - 8):
                if np.linalg.norm(gt[i][:3] - gt[j][:3]) < sensor_range / 3:
                    t = _se3_mul(_se3_inv(gt[j]), gt[i])
                    g.add_edge(EdgeSE3, [j, i], noisy_se3(t), info_odo)
                    break

    if "pose_offset" in sensors:
        # SensorPose3DOffset (``sensor_pose3d_offset.cpp:35-117``):
        # EDGE_SE3_OFFSET observations of spatially-close earlier poses
        # through TWO SE3 offset parameters; information
        # diag(100,100,100,1e4,1e4,1e3) as the reference ctor sets, noise a
        # right-multiplied MQT perturbation (``addNoise``, :57-62)
        off1 = np.array([0.1, -0.05, 0.2, 0, 0, 0, 1.0])
        off2 = np.array([-0.02, 0.08, 0.1, 0, 0, 0, 1.0])
        pid1, pid2 = 300000, 300001
        g.add_parameter(pid1, off1)
        g.add_parameter(pid2, off2)
        info_po = np.diag([100.0, 100, 100, 1e4, 1e4, 1e3])
        steps_to_ignore = 8     # reference _stepsToIgnore=10 scaled down
        for i in range(n_poses):
            for j in range(i - steps_to_ignore):
                if np.linalg.norm(gt[i][:3] - gt[j][:3]) < sensor_range / 3:
                    # measurementFromState: (x_j*O1)^-1 * (x_i*O2)
                    t = _se3_mul(_se3_inv(_se3_mul(gt[j], off1)),
                                 _se3_mul(gt[i], off2))
                    g.add_edge(EdgeSE3Offset, [j, i], noisy_se3(t), info_po,
                               param_id=(pid1, pid2))
                    break

    if "se3prior" in sensors:
        # SensorSE3Prior (``sensor_se3_prior.cpp:33-81``): unary
        # EDGE_SE3_PRIOR on the trajectory through an SE3 offset parameter
        # (a GPS/mocap-style global pose measurement); information
        # identity*1000 with (2,2)=10 as the reference ctor sets
        prior_pid = 300002
        prior_off = np.array([0.05, 0.0, -0.1, 0, 0, 0, 1.0])
        g.add_parameter(prior_pid, prior_off)
        info_prior = np.diag([1000.0, 1000, 10, 1000, 1000, 1000])
        for i in range(n_poses):
            # measurementFromState: x_i * O
            t = _se3_mul(gt[i], prior_off)
            g.add_edge(EdgeSE3Prior, [i], noisy_se3(t), info_prior,
                       param_id=prior_pid)

    vid_next = n_poses
    seen = set()
    lm_vid0 = vid_next
    vid_next += n_landmarks
    if "trackxyz" in sensors:
        for i, p in enumerate(gt):
            R = _quat_to_matrix(p[3:])
            for k in range(n_landmarks):
                rel = landmarks[k] - p[:3]
                if np.linalg.norm(rel) >= sensor_range:
                    continue
                local = R.T @ rel
                vid = lm_vid0 + k
                if vid not in seen:
                    obs = local + nrm(landmark_noise)
                    g.add_vertex(vid, VertexPointXYZ, p[:3] + R @ obs)
                    seen.add(vid)
                obs = local + nrm(landmark_noise)
                g.add_edge(EdgeSE3PointXYZ, [i, vid], obs, info_lm,
                           param_id=0)

    cam_sensors = {"depth", "disparity"} & set(sensors)
    if cam_sensors:
        # camera looks along the robot's +x: offset rotation maps
        # camera z onto robot x (param layout [offset(7), fx fy cx cy],
        # ``parameter_camera.cpp:63-84``)
        cam_off = _se3(_roty(np.pi / 2), np.zeros(3))
        cam_pid = 200000
        g.add_parameter(cam_pid, np.concatenate(
            [cam_off, [focal, focal, cx, cy]]))
        info_depth = np.diag([1.0 / pixel_noise ** 2, 1.0 / pixel_noise ** 2,
                              1.0 / depth_noise ** 2])
        for i, p in enumerate(gt):
            Rs = _quat_to_matrix(p[3:]) @ _roty(np.pi / 2)
            ts = p[:3]
            for k in range(n_landmarks):
                pc = Rs.T @ (landmarks[k] - ts)
                z = pc[2]
                if not (0.5 < z < sensor_range):
                    continue
                u = focal * pc[0] / z + cx
                v = focal * pc[1] / z + cy
                if not (0 <= u < 2 * cx and 0 <= v < 2 * cy):
                    continue
                vid = lm_vid0 + k
                if vid not in seen:
                    pw = ts + Rs @ (pc + nrm(landmark_noise))
                    g.add_vertex(vid, VertexPointXYZ, pw)
                    seen.add(vid)
                if "depth" in sensors:
                    m = np.array([u + nrm(pixel_noise),
                                  v + nrm(pixel_noise),
                                  z + nrm(depth_noise)])
                    g.add_edge(EdgeSE3PointXYZDepth, [i, vid], m,
                               info_depth, param_id=cam_pid)
                if "disparity" in sensors:
                    m = np.array([u + nrm(pixel_noise),
                                  v + nrm(pixel_noise),
                                  1.0 / z + nrm(depth_noise) / z])
                    g.add_edge(EdgeSE3PointXYZDisparity, [i, vid], m,
                               info_depth, param_id=cam_pid)

    if "line3d" in sensors:
        line_vid0 = vid_next
        vid_next += n_lines
        # Plücker lines through random point pairs near the workspace
        A = rng.uniform(-world_size / 2, world_size / 2, size=(n_lines, 3))
        B = A + rng.normal(size=(n_lines, 3))
        D = B - A
        D /= np.linalg.norm(D, axis=1, keepdims=True)
        Wm = np.cross(A, D)
        info_line = np.eye(4) / line_noise ** 2
        line_seen = set()

        def line_xform(Rinv, tinv, w, d):
            d2 = Rinv @ d
            w2 = Rinv @ w + np.cross(tinv, d2)
            return np.concatenate([w2, d2])

        for i, p in enumerate(gt):
            R = _quat_to_matrix(p[3:])
            Rinv, tinv = R.T, -R.T @ p[:3]
            for k in range(n_lines):
                dist = np.linalg.norm(Wm[k] - np.cross(p[:3], D[k]))
                if dist >= sensor_range:
                    continue
                loc = line_xform(Rinv, tinv, Wm[k], D[k])
                # noise: small rigid rotation of (w, d) + moment scaling —
                # keeps the Plücker constraint w·d = 0
                Rn = small_rot(line_noise)
                m = np.concatenate([Rn @ loc[:3] * (1 + nrm(line_noise)),
                                    Rn @ loc[3:]])
                vid = line_vid0 + k
                if vid not in line_seen:
                    Rn0 = small_rot(line_noise)
                    g.add_vertex(vid, VertexLine3D, np.concatenate(
                        [Rn0 @ Wm[k], Rn0 @ D[k]]))
                    line_seen.add(vid)
                g.add_edge(EdgeSE3Line3D, [i, vid], m, info_line)

    if "plane" in sensors:
        plane_vid0 = vid_next
        vid_next += n_planes
        # calibration offset vertex (known/fixed sensor mount)
        calib_vid = vid_next
        vid_next += 1
        calib_pose = np.array([0.1, 0.0, 0.05, 0, 0, 0, 1.0])
        g.add_vertex(calib_vid, VertexSE3, calib_pose, fixed=True)
        N = rng.normal(size=(n_planes, 3))
        N /= np.linalg.norm(N, axis=1, keepdims=True)
        Wp = rng.uniform(-world_size / 2, world_size / 2, size=n_planes)
        info_plane = np.eye(3) / plane_noise ** 2
        plane_seen = set()
        for i, p in enumerate(gt):
            sensor = _se3_mul(p, calib_pose)
            Rs = _quat_to_matrix(sensor[3:])
            for k in range(n_planes):
                if abs(N[k] @ p[:3] + Wp[k]) >= sensor_range:
                    continue
                n_l = Rs.T @ N[k]
                w_l = Wp[k] + sensor[:3] @ N[k]
                Rn = small_rot(plane_noise)
                m = np.concatenate([Rn @ n_l, [w_l + nrm(plane_noise)]])
                vid = plane_vid0 + k
                if vid not in plane_seen:
                    Rn0 = small_rot(plane_noise)
                    g.add_vertex(vid, VertexPlane, np.concatenate(
                        [Rn0 @ N[k], [Wp[k] + nrm(plane_noise)]]))
                    plane_seen.add(vid)
                g.add_edge(EdgeSE3PlaneCalib, [i, vid, calib_vid], m,
                           info_plane)
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
