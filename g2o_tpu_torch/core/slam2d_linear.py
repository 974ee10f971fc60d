"""Linear initialization for 2D pose graphs — port of
``g2o_tpu/core/slam2d_linear.py``, the analogue of the reference
``SolverSLAM2DLinear`` (``g2o/solvers/slam2d_linear/``, Carlone et al.):

1. propagate orientations along a spanning tree;
2. compute the integer 2π wrap count of every relative-orientation
   measurement against the propagated guess;
3. solve the now-linear orientation least squares;
4. with orientations fixed, the translation part of every EDGE_SE2 is
   linear — solve the position least squares;
5. (caller then runs GN/LM from this initialization, as the reference's
   wrapped solver does.)

Both linear solves reuse the framework itself: orientations/positions are
posed as small auxiliary problems with additive vertices and linear edges
(private types in a registry of their own, linearized with ``torch.func``
as every registered type is), so one Gauss-Newton step with
:class:`PCGSolver` is the exact LS solution, computed on ``device``.
"""

from __future__ import annotations

import numpy as np

from g2o_tpu_torch.core.graph import Graph
from g2o_tpu_torch.core.initial_guess import compute_initial_guess
from g2o_tpu_torch.core.optimizer import GaussNewton, SparseOptimizer
from g2o_tpu_torch.core.solvers.pcg import PCGSolver
from g2o_tpu_torch.core.types import EdgeType, TypeRegistry, VertexType

_VertexTheta = VertexType(
    name="_slam2d_linear_theta", rep_dim=1, tangent_dim=1,
    oplus=lambda x, d: x + d)


def _theta_edge():
    def residual(states, meas, param):
        ti, tj = states
        return (tj - ti) - meas

    return EdgeType(
        name="_slam2d_linear_theta_edge",
        vertex_types=(_VertexTheta, _VertexTheta),
        residual_dim=1, residual=residual, meas_dim=1)


_VertexPos = VertexType(
    name="_slam2d_linear_pos", rep_dim=2, tangent_dim=2,
    oplus=lambda x, d: x + d)


def _pos_edge():
    def residual(states, meas, param):
        pi, pj = states
        return (pj - pi) - meas

    return EdgeType(
        name="_slam2d_linear_pos_edge",
        vertex_types=(_VertexPos, _VertexPos),
        residual_dim=2, residual=residual, meas_dim=2)


def _registry(vt, et):
    reg = TypeRegistry()
    reg.register_vertex(vt)
    reg.register_edge(et)
    return reg


def _solve_linear(g, solver_iters, dtype, device):
    """One Gauss-Newton step on the auxiliary problem ``g``: the exact
    least-squares solution.  Returns the compiled problem."""
    p = g.compile(dtype=dtype, device=device)
    SparseOptimizer(p, algorithm=GaussNewton(),
                    solver=PCGSolver(max_iter=solver_iters, tol=1e-10)
                    ).optimize(1)
    return p


def solve_slam2d_linear(graph: Graph, *, solver_iters: int = 200,
                        dtype=None, device="cuda") -> int:
    """Compute the linear orientation+position initialization in place.
    Returns the number of initialised poses.  Only EDGE_SE2 edges between
    VERTEX_SE2 vertices participate.  The two linear solves run in
    ``dtype`` (float64 when None) on ``device``."""
    se2_edges = [e for e in graph.edges() if e.etype.name == "EDGE_SE2"]
    vids = sorted({v for e in se2_edges for v in e.vids})
    if not se2_edges:
        return 0

    # 1. spanning-tree orientation guess
    compute_initial_guess(graph)
    theta0 = {vid: graph.vertex(vid).estimate[2] for vid in vids}

    fixed_ids = [vid for vid in vids if graph.vertex(vid).fixed]
    anchor = fixed_ids[0] if fixed_ids else vids[0]

    # 2.+3. linear orientation solve with integer wrap correction
    et_theta = _theta_edge()
    gt_ = Graph(_registry(_VertexTheta, et_theta))
    for vid in vids:
        gt_.add_vertex(vid, _VertexTheta, [theta0[vid]],
                       fixed=(vid == anchor))
    for e in se2_edges:
        i, j = e.vids
        delta = e.measurement[2]
        k = np.round((theta0[j] - theta0[i] - delta) / (2 * np.pi))
        w = max(float(e.information[2, 2]), 1e-12)
        gt_.add_edge(et_theta, [i, j], [delta + 2 * np.pi * k],
                     np.array([[w]]))
    pt = _solve_linear(gt_, solver_iters, dtype, device)
    theta_host = pt.estimates_by_vid()
    theta = {vid: float(theta_host[vid][0]) for vid in vids}

    # 4. linear position solve with fixed orientations
    et_pos = _pos_edge()
    gp = Graph(_registry(_VertexPos, et_pos))
    for vid in vids:
        est = graph.vertex(vid).estimate
        gp.add_vertex(vid, _VertexPos, est[:2], fixed=(vid == anchor))
    for e in se2_edges:
        i, j = e.vids
        c, s = np.cos(theta[i]), np.sin(theta[i])
        R = np.array([[c, -s], [s, c]])
        world_delta = R @ e.measurement[:2]
        info = e.information[:2, :2]
        gp.add_edge(et_pos, [i, j], world_delta, R @ info @ R.T)
    pp = _solve_linear(gp, solver_iters, dtype, device)

    pos_host = pp.estimates_by_vid()
    for vid in vids:
        pos = pos_host[vid]
        th = (theta[vid] + np.pi) % (2 * np.pi) - np.pi
        graph.set_estimate(vid, np.array([pos[0], pos[1], th]))
    return len(vids)
