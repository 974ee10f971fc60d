"""Curve fitting with a custom edge type — port of
``examples/curve_fit.py``, the analogue of the reference
``examples/data_fitting/curve_fit.cpp``: fit ``y = a*exp(-lambda*x) + b``
to noisy samples by declaring a 3-dof parameter vertex and a 1-dof
observation edge, then running LM.

Run: python -m g2o_tpu_torch.examples.curve_fit [-device cpu]
"""

import numpy as np
import torch

from g2o_tpu_torch.core.graph import Graph
from g2o_tpu_torch.core.optimizer import LevenbergMarquardt, SparseOptimizer
from g2o_tpu_torch.core.solvers import DenseSolver
from g2o_tpu_torch.core.types import EdgeType, VertexType
from g2o_tpu_torch.examples import split_device

# --- declare the types (the whole "plugin") ---

VertexParams = VertexType(
    name="curve_params",
    rep_dim=3,            # (a, b, lambda)
    tangent_dim=3,
    oplus=lambda x, d: x + d,
)


def curve_residual(states, meas, param):
    (p,) = states
    a, b, lam = p[..., 0], p[..., 1], p[..., 2]
    x, y = meas[..., 0], meas[..., 1]
    return (a * torch.exp(-lam * x) + b - y)[..., None]


EdgeCurvePoint = EdgeType(
    name="curve_point",
    vertex_types=(VertexParams,),
    residual_dim=1,
    residual=curve_residual,
    meas_dim=2,           # (x, y) sample
)


def main(argv=None):
    device, _ = split_device(argv)
    a, b, lam = 2.0, 0.4, 0.2
    rng = np.random.default_rng(0)
    xs = rng.uniform(0, 10, size=50)
    ys = a * np.exp(-lam * xs) + b + rng.normal(scale=0.02, size=xs.shape)

    g = Graph()
    g.add_vertex(0, VertexParams, [1.0, 1.0, 1.0])   # poor initial guess
    for x, y in zip(xs, ys):
        g.add_edge(EdgeCurvePoint, [0], [x, y], np.eye(1))

    p = g.compile(device=device)
    opt = SparseOptimizer(p, algorithm=LevenbergMarquardt(),
                          solver=DenseSolver(), verbose=True)
    opt.optimize(20)
    est = p.get_estimate(0)
    print(f"\ntruth:    a={a} b={b} lambda={lam}")
    print(f"estimate: a={est[0]:.4f} b={est[1]:.4f} lambda={est[2]:.4f}")
    return est


if __name__ == "__main__":
    main()
