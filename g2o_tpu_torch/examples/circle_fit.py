"""Circle fitting — port of ``examples/circle_fit.py``, the analogue of
the reference ``examples/data_fitting/circle_fit.cpp``: fit center +
radius to noisy points on a circle.

Run: python -m g2o_tpu_torch.examples.circle_fit [-device cpu]
"""

import numpy as np
import torch

from g2o_tpu_torch.core.graph import Graph
from g2o_tpu_torch.core.optimizer import LevenbergMarquardt, SparseOptimizer
from g2o_tpu_torch.core.solvers import DenseSolver
from g2o_tpu_torch.core.types import EdgeType, VertexType
from g2o_tpu_torch.examples import split_device

VertexCircle = VertexType(
    name="circle",
    rep_dim=3,            # (cx, cy, r)
    tangent_dim=3,
    oplus=lambda x, d: x + d,
)


def circle_residual(states, meas, param):
    (c,) = states
    return (torch.linalg.vector_norm(meas - c[..., :2], dim=-1)
            - c[..., 2])[..., None]


EdgeCirclePoint = EdgeType(
    name="circle_point",
    vertex_types=(VertexCircle,),
    residual_dim=1,
    residual=circle_residual,
    meas_dim=2,
)


def main(argv=None):
    device, _ = split_device(argv)
    center, radius = np.array([4.0, 2.0]), 2.0
    rng = np.random.default_rng(1)
    th = rng.uniform(0, 2 * np.pi, 100)
    pts = center + (radius + rng.normal(scale=0.05, size=th.shape))[:, None] \
        * np.stack([np.cos(th), np.sin(th)], axis=1)

    g = Graph()
    g.add_vertex(0, VertexCircle, [3.0, 3.0, 3.0])
    for pt in pts:
        g.add_edge(EdgeCirclePoint, [0], pt, np.eye(1))
    p = g.compile(device=device)
    opt = SparseOptimizer(p, algorithm=LevenbergMarquardt(),
                          solver=DenseSolver())
    opt.optimize(20)
    est = p.get_estimate(0)
    print(f"truth:    center=({center[0]}, {center[1]}) r={radius}")
    print(f"estimate: center=({est[0]:.4f}, {est[1]:.4f}) r={est[2]:.4f}")
    return est


if __name__ == "__main__":
    main()
