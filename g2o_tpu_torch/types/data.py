"""Typed sensor-data payloads — port of ``g2o_tpu/types/data.py`` (the
reference is ``g2o/types/data``, ``robot_laser.cpp:50-90``): parse and
serialize ROBOTLASER1 lines into a record (laser parameters, ranges,
remissions, laser and odometry pose, velocities, timestamps).  The raw
lines stay attached to their vertex through ``Graph.add_vertex_data``;
this module gives the typed view of them."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RobotLaser:
    """One ROBOTLASER1 record (CARMEN style)."""

    type: int = 0
    first_beam_angle: float = -np.pi / 2
    fov: float = np.pi
    angular_step: float = 0.0
    max_range: float = 0.0
    accuracy: float = 0.0
    remission_mode: int = 0
    ranges: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))
    remissions: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))
    laser_pose: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))   # world frame, as serialized
    odom_pose: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    laser_tv: float = 0.0
    laser_rv: float = 0.0
    forward_safety_dist: float = 0.0
    side_safety_dist: float = 0.0
    turn_axis: float = 0.0
    timestamp: float = 0.0
    hostname: str = "hostname"
    logger_timestamp: float = 0.0

    @classmethod
    def parse(cls, line: str) -> "RobotLaser":
        tok = line.split()
        if tok[0] != "ROBOTLASER1":
            raise ValueError(f"not a ROBOTLASER1 line: {tok[0]}")
        it = iter(tok[1:])
        rl = cls()
        rl.type = int(next(it))
        rl.first_beam_angle = float(next(it))
        rl.fov = float(next(it))
        rl.angular_step = float(next(it))
        rl.max_range = float(next(it))
        rl.accuracy = float(next(it))
        rl.remission_mode = int(next(it))
        n = int(next(it))
        rl.ranges = np.array([float(next(it)) for _ in range(n)])
        m = int(next(it))
        rl.remissions = np.array([float(next(it)) for _ in range(m)])
        rl.laser_pose = np.array([float(next(it)) for _ in range(3)])
        rl.odom_pose = np.array([float(next(it)) for _ in range(3)])
        rl.laser_tv = float(next(it))
        rl.laser_rv = float(next(it))
        rl.forward_safety_dist = float(next(it))
        rl.side_safety_dist = float(next(it))
        rl.turn_axis = float(next(it))
        try:            # the timestamps and host name are optional
            rl.timestamp = float(next(it))
            rl.hostname = next(it)
            rl.logger_timestamp = float(next(it))
        except StopIteration:
            pass
        return rl

    def serialize(self) -> str:
        parts = ["ROBOTLASER1", str(self.type)]
        parts += [f"{v:.10g}" for v in (
            self.first_beam_angle, self.fov, self.angular_step,
            self.max_range, self.accuracy)]
        parts.append(str(self.remission_mode))
        parts.append(str(len(self.ranges)))
        parts += [f"{v:.10g}" for v in self.ranges]
        parts.append(str(len(self.remissions)))
        parts += [f"{v:.10g}" for v in self.remissions]
        parts += [f"{v:.10g}" for v in self.laser_pose]
        parts += [f"{v:.10g}" for v in self.odom_pose]
        parts += [f"{v:.10g}" for v in (
            self.laser_tv, self.laser_rv, self.forward_safety_dist,
            self.side_safety_dist, self.turn_axis, self.timestamp)]
        parts.append(self.hostname)
        parts.append(f"{self.logger_timestamp:.10g}")
        return " ".join(parts)

    def cartesian(self) -> np.ndarray:
        """(N, 2) scan endpoints in the laser frame (valid ranges only)."""
        angles = self.first_beam_angle + self.angular_step * np.arange(
            len(self.ranges))
        valid = self.ranges < self.max_range
        r, a = self.ranges[valid], angles[valid]
        return np.stack([r * np.cos(a), r * np.sin(a)], axis=1)


def parse_vertex_payloads(graph, vid):
    """Typed views of a vertex's attached payload lines."""
    return [RobotLaser.parse(line) for line in graph.vertex_data(vid)
            if line.startswith("ROBOTLASER1")]
