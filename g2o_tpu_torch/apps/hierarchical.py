"""Hierarchical (multilevel) pose-graph optimization — port of
``g2o_tpu/apps/hierarchical.py``, the analogue of the reference
``g2o_hierarchical`` app (``apps/g2o_hierarchical/``, SURVEY.md §2.4):

1. decompose the graph into *stars*: BFS balls of radius ``star_radius``
   around evenly spaced central poses (the reference grows stars over a
   Dijkstra backbone, ``star.h:52``); landmarks (any non-backbone vertex
   type) are assigned to the star that observes them most;
2. optimize each star locally with its centre fixed (gauge);
3. *edge labeling* (``edge_labeler.h:45``): for each star, create condensed
   level-1 edges centre→boundary whose measurement is the locally optimized
   relative transform (pose targets) or the locally optimized landmark
   position in the centre frame (landmark targets — the reference's
   ``EdgeCreator`` picks the pose→landmark observation edge for these,
   ``edge_creator.h:45``), and whose information is the inverse of the
   target's marginal covariance in the star subproblem;
4. optimize the level-1 skeleton over the centres + boundary vertices;
5. re-anchor every star rigidly to its optimized centre (landmarks move as
   points under the rigid delta) and run a final low-level refinement.

Backbone vertex types with a group structure are registered in
``_GROUP_OPS`` (SE2 and SE3); landmark types ride per-(pose, landmark)
condensed-observation specs in ``_OBS_OPS`` (XY and TRACKXYZ).

The decomposition, the skeleton's construction and the re-anchoring run on
the host (the group operations through :mod:`g2o_tpu_torch.ops.lie` on
float64 CPU tensors); the three optimizations and the marginals run on
``device`` (the CUDA card unless the caller passes ``device="cpu"``) in
``dtype``.  With ``G2O_ENABLE_TICTOC`` set, the stages are timed under the
:mod:`~g2o_tpu_torch.utils.tictoc` keys ``hierarchical_stars``,
``hierarchical_marginals``, ``hierarchical_skeleton`` and
``hierarchical_refine`` (a recursion adds its own levels to the same
keys).
"""

from __future__ import annotations

import numpy as np
import torch

from g2o_tpu_torch.core.graph import Graph
from g2o_tpu_torch.core.marginals import compute_marginals
from g2o_tpu_torch.core.optimizer import LevenbergMarquardt, SparseOptimizer
from g2o_tpu_torch.core.solvers import PCGSolver
from g2o_tpu_torch.ops import lie
from g2o_tpu_torch.utils.tictoc import tictoc


def _host(fn):
    """``fn`` of the ``lie`` module on float64 CPU tensors, numpy in and
    out."""
    return lambda *xs: fn(*(torch.as_tensor(np.asarray(x, np.float64))
                            for x in xs)).numpy()


_GROUP_OPS = {
    "VERTEX_SE2": dict(
        compose=_host(lie.se2_compose),
        inverse=_host(lie.se2_inverse),
        act=_host(lie.se2_act),
        edge="EDGE_SE2",
    ),
    "VERTEX_SE3:QUAT": dict(
        compose=_host(lie.se3_compose),
        inverse=_host(lie.se3_inverse),
        act=_host(lie.se3_act),
        edge="EDGE_SE3:QUAT",
    ),
}

# condensed centre→landmark observation edges, keyed by
# (pose type, landmark type): the EdgeCreator table of the reference
# (``apps/g2o_hierarchical/edge_creator.h:45`` builds the same
# pose-landmark edge from the type pair).  ``param`` supplies the shared
# parameter value for param-bearing edge types (identity sensor offset —
# the condensed measurement is expressed directly in the centre frame).
_OBS_OPS = {
    ("VERTEX_SE2", "VERTEX_XY"): dict(edge="EDGE_SE2_XY", param=None),
    ("VERTEX_SE3:QUAT", "VERTEX_TRACKXYZ"): dict(
        edge="EDGE_SE3_TRACKXYZ",
        param=np.array([0, 0, 0, 0, 0, 0, 1.0])),
}


def _bfs_stars(graph: Graph, star_radius: int, pose_type: str):
    """Partition backbone (pose) vertices into stars over the pose-pose
    adjacency; returns (centers, star_of_vid) covering poses only."""
    is_pose = {vid: rec.vtype.name == pose_type
               for vid, rec in graph.vertices().items()}
    adj: dict[int, set] = {}
    for e in graph.edges():
        pv = [v for v in e.vids if is_pose[v]]
        for a in pv:
            for b in pv:
                if a != b:
                    adj.setdefault(a, set()).add(b)
    unassigned = {v for v, p in is_pose.items() if p}
    star_of = {}
    centers = []
    order = sorted(unassigned)
    from collections import deque

    for seed in order:
        if seed not in unassigned:
            continue
        centers.append(seed)
        sid = len(centers) - 1
        q = deque([(seed, 0)])
        while q:
            v, d = q.popleft()
            if v not in unassigned:
                continue
            unassigned.discard(v)
            star_of[v] = sid
            if d < star_radius:
                for w in adj.get(v, ()):
                    if w in unassigned:
                        q.append((w, d + 1))
    return centers, star_of


def _assign_satellites(graph: Graph, star_of: dict, pose_type: str):
    """Assign each non-backbone vertex to the star observing it most (the
    reference adds a landmark to the star of its observing poses,
    ``star.h`` star construction); isolated satellites fall back to any
    already-assigned neighbour's star."""
    votes: dict[int, dict] = {}
    for e in graph.edges():
        pose_stars = [star_of[v] for v in e.vids if v in star_of]
        for v in e.vids:
            if v in star_of or graph.vertex(v).vtype.name == pose_type:
                continue
            for s in pose_stars:
                votes.setdefault(v, {})[s] = votes.get(v, {}).get(s, 0) + 1
    pending = [vid for vid, rec in graph.vertices().items()
               if vid not in star_of and rec.vtype.name != pose_type]
    for vid in pending:
        vv = votes.get(vid)
        if vv:
            star_of[vid] = max(sorted(vv), key=lambda s: vv[s])
    # satellites with NO observing pose (landmark-landmark chains): follow
    # any already-assigned neighbour's star, propagating until settled;
    # fully isolated leftovers default to star 0
    remaining = [v for v in pending if v not in star_of]
    if remaining:
        nbrs: dict[int, set] = {}
        for e in graph.edges():
            for a in e.vids:
                for b in e.vids:
                    if a != b:
                        nbrs.setdefault(a, set()).add(b)
        changed = True
        while changed and remaining:
            changed = False
            still = []
            for vid in remaining:
                hit = next((star_of[w] for w in sorted(nbrs.get(vid, ()))
                            if w in star_of), None)
                if hit is not None:
                    star_of[vid] = hit
                    changed = True
                else:
                    still.append(vid)
            remaining = still
        for vid in remaining:
            star_of[vid] = 0
    return star_of


def optimize_hierarchical(graph: Graph, *, star_radius: int = 4,
                          star_iterations: int = 10,
                          skeleton_iterations: int = 30,
                          refine_iterations: int = 10,
                          max_levels: int = 2,
                          recurse_threshold: int = 300,
                          verbose: bool = False, dtype=None,
                          device="cuda"):
    """Run the full multilevel pipeline in place on ``graph``; every
    problem is built in ``dtype`` (float64 when None) on ``device``.

    ``max_levels`` > 2 recursively condenses the skeleton itself while it
    still has more than ``recurse_threshold`` vertices — the arbitrary-
    depth analogue of the reference's ``Edge::level()`` hierarchy
    (``core/optimizable_graph.h:437-439``).  Returns a summary dict."""
    vtypes = {r.vtype.name for r in graph.vertices().values()}
    pose_types = vtypes & set(_GROUP_OPS)
    if len(pose_types) != 1:
        raise NotImplementedError(
            f"hierarchical: exactly one SE2/SE3 backbone type required, "
            f"got {vtypes}")
    tname = next(iter(pose_types))
    sat_types = vtypes - pose_types
    missing = [s for s in sat_types if (tname, s) not in _OBS_OPS]
    if missing:
        raise NotImplementedError(
            f"hierarchical: no condensed-edge spec for landmark types "
            f"{missing} under backbone {tname}")
    ops = _GROUP_OPS[tname]
    vt = graph.registry.vertex_types[tname]
    et_skel = graph.registry.edge_types[ops["edge"]]

    with tictoc("hierarchical_stars"):
        centers, star_of = _bfs_stars(graph, star_radius, tname)
        star_of = _assign_satellites(graph, star_of, tname)
    n_stars = len(centers)

    # --- per-star local optimization, BATCHED as one block-diagonal
    # problem: stars partition the vertices, so the union of all star
    # subproblems (intra-star edges only, every centre fixed) is a single
    # graph whose Hessian is block-diagonal across stars — ONE problem
    # build and ONE LM run on the device instead of one small run (and
    # its launches) per star, and a single marginals solve recovers every
    # star's boundary covariances (other stars don't couple, so the H^-1
    # blocks are star-local).  The reference optimizes stars one by one
    # (``star.h:52``). ---
    star_members: list[list[int]] = [[] for _ in range(n_stars)]
    for vid, sid in star_of.items():
        star_members[sid].append(vid)
    center_set = set(centers)

    local_g = Graph(graph.registry)
    for pid, val in graph._parameters.items():
        local_g.add_parameter(pid, val)
    for vid in sorted(graph.vertices()):
        rec = graph.vertex(vid)
        local_g.add_vertex(vid, rec.vtype, rec.estimate,
                           fixed=(vid in center_set))
    boundary_of: list[set] = [set() for _ in range(n_stars)]
    n_intra = 0
    for e in graph.edges():
        sids = {star_of[v] for v in e.vids}
        if len(sids) == 1:
            local_g.add_edge(e.etype, e.vids, e.measurement, e.information,
                             kernel=e.kernel, delta=e.delta,
                             param_id=e.param_id)
            n_intra += 1
        else:
            for v in e.vids:
                boundary_of[star_of[v]].add(v)

    if n_intra:
        with tictoc("hierarchical_stars"):
            p = local_g.compile(dtype=dtype, device=device)
            opt = SparseOptimizer(p, algorithm=LevenbergMarquardt(),
                                  solver=PCGSolver(max_iter=100, tol=1e-8))
            opt.optimize(star_iterations)
            local = p.estimates_by_vid()
    else:
        p = None
        local = {vid: graph.vertex(vid).estimate
                 for vid in graph.vertices()}
    est_after_star = {vid: np.asarray(v) for vid, v in local.items()}

    # condensed edges: centre -> each boundary member (or one frontier
    # member for interior stars); all marginal covariances in one solve
    targets_of = []
    all_targets = []
    for sid, center in enumerate(centers):
        members = set(star_members[sid])
        targets = sorted(boundary_of[sid] - {center}) or \
            sorted(m for m in members - {center}
                   if graph.vertex(m).vtype.name == tname)[:1]
        targets_of.append(targets)
        all_targets.extend(targets)
    with tictoc("hierarchical_marginals"):
        margs = compute_marginals(p, all_targets, lam=1e-9) \
            if p is not None else {}

    skeleton = Graph(graph.registry)
    for pid, val in graph._parameters.items():
        skeleton.add_parameter(pid, val)
    obs_pids: dict[str, int] = {}      # identity-offset params we add

    def _info_for(vid, dim):
        if vid in margs:
            cov = margs[vid]
            return np.linalg.inv(cov + 1e-9 * np.eye(cov.shape[0]))
        return np.eye(dim)

    for sid, center in enumerate(centers):
        if not skeleton.has_vertex(center):
            skeleton.add_vertex(center, vt, local[center],
                                fixed=(sid == 0))
        for vid in targets_of[sid]:
            rec = graph.vertex(vid)
            if not skeleton.has_vertex(vid):
                skeleton.add_vertex(vid, rec.vtype, local[vid])
            if rec.vtype.name == tname:
                meas = ops["compose"](ops["inverse"](local[center]),
                                      local[vid])
                skeleton.add_edge(et_skel, [center, vid], meas,
                                  _info_for(vid, vt.tangent_dim))
            else:
                # condensed observation: landmark in the centre frame
                # (edge_labeler.h:45 virtual measurement; the information
                # is the star-local marginal, as there)
                spec = _OBS_OPS[(tname, rec.vtype.name)]
                et_obs = graph.registry.edge_types[spec["edge"]]
                meas = ops["act"](ops["inverse"](local[center]), local[vid])
                pid = None
                if spec["param"] is not None:
                    if spec["edge"] not in obs_pids:
                        newpid = max(skeleton._parameters, default=-1) + 1
                        skeleton.add_parameter(newpid, spec["param"])
                        obs_pids[spec["edge"]] = newpid
                    pid = obs_pids[spec["edge"]]
                skeleton.add_edge(et_obs, [center, vid], meas,
                                  _info_for(vid, rec.vtype.tangent_dim),
                                  param_id=pid)

    # connect the skeleton: original edges crossing star boundaries whose
    # endpoints all survived condensation (pose-pose loop closures AND
    # cross-star landmark observations)
    for e in graph.edges():
        sids = {star_of[v] for v in e.vids}
        if len(sids) > 1 and all(skeleton.has_vertex(v) for v in e.vids):
            skeleton.add_edge(e.etype, e.vids, e.measurement, e.information,
                              kernel=e.kernel, delta=e.delta,
                              param_id=e.param_id)

    levels_used = 2
    if max_levels > 2 and skeleton.num_vertices > recurse_threshold:
        # condense the skeleton again: the level-2 (and deeper) hierarchy
        sub = optimize_hierarchical(
            skeleton, star_radius=star_radius,
            star_iterations=star_iterations,
            skeleton_iterations=skeleton_iterations,
            refine_iterations=skeleton_iterations,
            max_levels=max_levels - 1,
            recurse_threshold=recurse_threshold, verbose=verbose,
            dtype=dtype, device=device)
        levels_used = sub["levels"] + 1
        skel_est = {vid: skeleton.vertex(vid).estimate
                    for vid in skeleton.vertices()}
    else:
        with tictoc("hierarchical_skeleton"):
            ps = skeleton.compile(dtype=dtype, device=device)
            opt_s = SparseOptimizer(ps, algorithm=LevenbergMarquardt(),
                                    solver=PCGSolver(max_iter=100, tol=1e-8),
                                    verbose=verbose)
            opt_s.optimize(skeleton_iterations)
            skel_est = ps.estimates_by_vid()

    # --- re-anchor stars rigidly to the optimized centres (landmarks move
    # as points under the rigid delta) ---
    for sid, center in enumerate(centers):
        old_c = est_after_star[center]
        new_c = np.asarray(skel_est[center])
        delta = ops["compose"](new_c, ops["inverse"](old_c))
        for vid in star_members[sid]:
            if graph.vertex(vid).vtype.name == tname:
                graph.set_estimate(
                    vid, ops["compose"](delta, est_after_star[vid]))
            else:
                graph.set_estimate(
                    vid, ops["act"](delta, est_after_star[vid]))

    # --- final low-level refinement ---
    with tictoc("hierarchical_refine"):
        p_final = graph.compile(dtype=dtype, device=device)
        opt_f = SparseOptimizer(p_final, algorithm=LevenbergMarquardt(),
                                solver=PCGSolver(max_iter=100, tol=1e-8),
                                verbose=verbose)
        opt_f.optimize(refine_iterations)
        for vid, est in p_final.estimates_by_vid().items():
            graph.set_estimate(vid, est)
    return {
        "n_stars": n_stars,
        "levels": levels_used,
        "skeleton_vertices": skeleton.num_vertices,
        "skeleton_edges": skeleton.num_edges,
        "final_chi2": opt_f.chi2(),
    }
