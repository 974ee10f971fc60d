"""Constant-velocity target tracking — port of
``examples/target_tracking.py``, the analogue of the reference
``examples/target/constant_velocity_target.cpp`` and
``static_target.cpp``: user-defined types outside the library (a 6-dof
position+velocity vertex, an accelerometer odometry edge, a GPS unary
edge), showing the "custom plugin" path of the framework — declare
``VertexType``/``EdgeType`` descriptors with residuals on tensors;
Jacobians come from ``torch.func`` automatically.

Run: python -m g2o_tpu_torch.examples.target_tracking [n_steps]
     [-device cpu]
"""

import sys

import numpy as np
import torch

from g2o_tpu_torch.core.graph import Graph
from g2o_tpu_torch.core.optimizer import GaussNewton, SparseOptimizer
from g2o_tpu_torch.core.solvers import PCGSolver
from g2o_tpu_torch.core.types import EdgeType, VertexType
from g2o_tpu_torch.examples import split_device

DT = 1.0

# state = (x, y, z, vx, vy, vz); Euclidean update
VertexPositionVelocity3D = VertexType(
    name="target_pos_vel_3d",
    rep_dim=6,
    tangent_dim=6,
    oplus=lambda x, d: x + d,
)


def _odometry_residual(states, meas, param):
    """Accelerometer odometry (reference TargetOdometry3DEdge,
    ``targetTypes6D.hpp:84-160``): predict the next state from the previous
    one plus the measured acceleration over dt."""
    prev, nxt = states
    a = meas
    pred_pos = prev[..., :3] + prev[..., 3:] * DT + 0.5 * a * DT * DT
    pred_vel = prev[..., 3:] + a * DT
    return torch.cat([pred_pos, pred_vel], dim=-1) - nxt


EdgeTargetOdometry = EdgeType(
    name="target_odometry_3d",
    vertex_types=(VertexPositionVelocity3D, VertexPositionVelocity3D),
    residual_dim=6,
    residual=_odometry_residual,
    meas_dim=3,
)


def _gps_residual(states, meas, param):
    """GPS position observation (reference
    GPSObservationEdgePositionVelocity3D, ``targetTypes6D.hpp:163-180``)."""
    (state,) = states
    return state[..., :3] - meas


EdgeGPSObservation = EdgeType(
    name="target_gps_3d",
    vertex_types=(VertexPositionVelocity3D,),
    residual_dim=3,
    residual=_gps_residual,
    meas_dim=3,
)


def main(argv=None):
    device, args = split_device(argv)
    n_steps = int(args[0]) if len(args) > 0 else 200
    accel_sigma, gps_sigma = 0.5, 1.0
    rng = np.random.default_rng(0)

    # ground-truth trajectory driven by random accelerations
    state = np.concatenate([1000 * rng.normal(size=3), np.zeros(3)])
    states, accels = [state], []
    for _ in range(n_steps - 1):
        a = rng.normal(size=3)
        accels.append(a)
        pos = state[:3] + state[3:] * DT + 0.5 * a * DT ** 2
        vel = state[3:] + a * DT
        state = np.concatenate([pos, vel])
        states.append(state)

    g = Graph()
    info_odo = np.eye(6) / accel_sigma ** 2
    info_gps = np.eye(3) / gps_sigma ** 2
    # initial guess: dead-reckon from a noisy start
    guess = states[0] + rng.normal(scale=5.0, size=6)
    for i, s in enumerate(states):
        g.add_vertex(i, VertexPositionVelocity3D, guess)
        g.add_edge(EdgeGPSObservation, [i],
                   s[:3] + rng.normal(scale=gps_sigma, size=3), info_gps)
    for i, a in enumerate(accels):
        g.add_edge(EdgeTargetOdometry, [i, i + 1],
                   a + rng.normal(scale=accel_sigma, size=3), info_odo)

    p = g.compile(device=device)
    opt = SparseOptimizer(p, algorithm=GaussNewton(),
                          solver=PCGSolver(max_iter=200), verbose=True)
    opt.optimize(5)

    errs = [np.linalg.norm(p.get_estimate(i)[:3] - states[i][:3])
            for i in range(n_steps)]
    print(f"smoothed position RMSE: {np.sqrt(np.mean(np.square(errs))):.3f} "
          f"(GPS sigma {gps_sigma})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
