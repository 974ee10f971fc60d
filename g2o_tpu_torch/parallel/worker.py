"""One process of an N-process run of the port — the counterpart of
``scripts/distributed_worker.py``.

Every process builds the same problem deterministically (as each host
would load its dataset), keeps its own edge rows, and runs the case; rank 0
writes the results as JSON to ``--out`` (each other rank writes its own
facts, its kernel launches among them, to ``--out.rank<r>``).

    python -m g2o_tpu_torch.parallel.worker \\
        --init-method tcp://127.0.0.1:PORT --nproc 2 --pid 0 \\
        [--device cpu|cuda] [--backend gloo|nccl] [--case multiprocess] \\
        [--iters 10] [--n-poses 200] --out out.json

Cases (``--case``, comma-separated):

* ``multiprocess`` (default): ``create_manhattan(n_poses, seed=7)`` over
  the ``(hosts, edges)`` mesh through ``shard_problem_data_global``,
  ``optimize_fused`` with ``PCGSolver(max_iter=100, tol=1e-10)`` for
  ``--iters`` iterations, float64;
* ``tests``: the small scenes of the JAX package's sharding tests, one
  sharded step (or run) each, every solver, float64 (the sphere read from
  ``--g2o`` when given);
* ``sphere`` (``--g2o`` file), ``manhattan`` (``--n-poses``), ``schur``,
  ``implicit``, ``runtime`` and ``cgls`` (``--bal`` file), ``mixed_sba``
  (``--sba-scene``): the full-size runs of ``chip_smoke.py``, each sharded
  result held against the same computation unsharded in rank 0, with ms
  per λ-trial, all-reduce counts and kernel launches (``runtime``: the
  implicit runtime-bucketed layout; ``cgls``: CGLS on the bucketed
  layout; ``mixed_sba``: the implicit multi-observer form).
"""

from __future__ import annotations

import argparse
import gzip
import io
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

import g2o_tpu_torch as g2o
from g2o_tpu_torch.core import problem as problem_mod
from g2o_tpu_torch.core.structure_only import structure_only_refine
from g2o_tpu_torch.parallel import (initialize_distributed, make_fused_step,
                                    make_global_mesh, make_mesh,
                                    replicate_estimates, shard_problem_data,
                                    shard_problem_data_global)
from g2o_tpu_torch.sim.generators import (create_ba_scene, create_manhattan,
                                          create_sphere)

F64 = torch.float64
SPHERE_LM_ITERS = 5
# the tests case's mixed mono/stereo scene (``mixed_sba_graph``)
MIXED_TEST_SCENE = dict(n_cameras=6, n_points=80, pixel_noise=0.5,
                        point_noise=0.2, seed=3)


def _lists(est):
    return {t: v.detach().cpu().double().numpy().tolist()
            for t, v in est.items()}


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def _wrappers():
    """The kernel wrappers, whose ``launches`` count their kernels'
    launches."""
    from g2o_tpu_torch.ops import chol_kernels as ck
    from g2o_tpu_torch.ops import onehot as oh
    from g2o_tpu_torch.ops import segment_kernels as sk

    return {"chol_batched": ck.chol_batched,
            "solve_lower_batched": ck.solve_lower_batched,
            "solve_upper_batched": ck.solve_upper_batched,
            "segment_sum": sk.segment_sum,
            **{k: getattr(oh, k) for k in (
                "onehot_gather", "onehot_gather_t", "onehot_scatter_add",
                "onehot_scatter_add_t")}}


def _zero_counts():
    for w in _wrappers().values():
        w.launches = 0
    problem_mod.REDUCE_STATS.update(calls=0, bytes=0, seconds=0.0)


def _counts():
    return {k: w.launches for k, w in _wrappers().items()}


def _reduce_facts(trials):
    st = problem_mod.REDUCE_STATS
    return {"allreduce_calls": st["calls"],
            "allreduce_calls_per_trial": st["calls"] / max(trials, 1),
            "allreduce_ms_per_call": st["seconds"] * 1e3 / max(st["calls"],
                                                              1),
            "allreduce_bytes_per_call": st["bytes"] / max(st["calls"], 1)}


def mixed_sba_graph(base, truth, graph_cls, sba, bf=75.0):
    """ORB-SLAM's mixed mono/stereo map on the points and observations of a
    ``create_ba_scene`` graph ``base`` (either package's: ``graph_cls`` and
    the ``sba`` types module are that package's): stereo edges (f, f, cx,
    cy, bf) from even cameras, with u_right = u - bf/z of the true depth
    (ba_demo's cameras: R = I, t_z = 0), mono edges (f, f, cx, cy) from
    odd ones; every point marginalized, one point type observed by two edge
    types."""
    f, cx, cy = base.parameter(sba.CAM_PARAM_ID)[:3]
    g = graph_cls()
    g.add_parameter(1, [f, f, cx, cy])
    g.add_parameter(2, [f, f, cx, cy, bf])
    verts = base.vertices()
    for vid, v in sorted(verts.items()):
        if vid not in truth:
            g.add_vertex(vid, v.vtype, v.estimate, fixed=v.fixed)
    for vid in truth:
        g.add_vertex(vid, sba.VertexPointXYZ, verts[vid].estimate,
                     marginalized=True)
    for e in base.edges():
        (v, i), m = e.vids, e.measurement
        if i % 2 == 0:
            g.add_edge(sba.EdgeStereoSE3ProjectXYZ, [v, i],
                       [m[0], m[1], m[0] - bf / truth[v][2]], np.eye(3),
                       param_id=2)
        else:
            g.add_edge(sba.EdgeSE3ProjectXYZ, [v, i], m, np.eye(2),
                       param_id=1)
    return g


# --------------------------------------------------------------------- #
# the default case: the JAX package's multi-process test
# --------------------------------------------------------------------- #

def case_multiprocess(args, world):
    g = create_manhattan(n_poses=args.n_poses, seed=7)
    p = g.compile(pad_edges_to_multiple=world, dtype=F64, device=args.device)
    mesh = make_global_mesh(hosts_axis=True)
    p.data = shard_problem_data_global(p.data, mesh)
    p.estimates = replicate_estimates(p.estimates, mesh)
    res = g2o.optimize_fused(p, g2o.PCGSolver(max_iter=100, tol=1e-10),
                             args.iters)
    return {"process_count": world, "process_index": dist.get_rank(),
            "n_devices": world,
            "mesh_shape": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
            "iterations": res["iterations"],
            "chi2_per_iteration": res["chi2_per_iteration"],
            "chi2_final": res["chi2_final"], "wall_s": res["wall_s"],
            "cg_per_iteration": res["cg_per_iteration"]}


# --------------------------------------------------------------------- #
# the CPU tests' cases
# --------------------------------------------------------------------- #

def _step(p, solver, mesh, lam, data=None):
    solver.setup(p)
    step = make_fused_step(p, solver, donate=False)
    data = shard_problem_data(p.data, mesh) if data is None else data
    est, chi, _ = step(data, replicate_estimates(p.estimates, mesh), lam)
    out = {"estimates": _lists(est), "chi2": float(chi)}
    if hasattr(solver, "_layout"):
        out["form"] = solver._layout["form"]
    return out


def case_tests(args, world):
    dev = args.device
    mesh = make_mesh()
    out = {}

    g, _ = create_ba_scene(n_cameras=10, n_points=150, pixel_noise=0.5,
                           point_noise=0.3, seed=21)
    p = g.compile(pad_edges_to_multiple=world, dtype=F64, device=dev)
    data = shard_problem_data(p.data, mesh)
    s = g2o.SchurSolver(mesh=mesh, use_pallas=True).setup(p)
    lin = p.linearize_fn(data, replicate_estimates(p.estimates, mesh))
    out["schur_step"] = {"dx": s.solve(data, lin, 1e-3).tolist()}

    g, _ = create_ba_scene(n_cameras=10, n_points=150, pixel_noise=0.0,
                           point_noise=0.3, seed=22)
    p = g.compile(pad_edges_to_multiple=world, dtype=F64, device=dev)
    p.data = shard_problem_data(p.data, mesh)
    p.estimates = replicate_estimates(p.estimates, mesh)
    res = g2o.optimize_fused(p, g2o.SchurSolver(mesh=mesh), 10)
    out["schur_lm"] = {k: res[k] for k in ("chi2_per_iteration",
                                           "chi2_final", "iterations")}

    g, _ = create_ba_scene(n_cameras=6, n_points=80, pixel_noise=0.5,
                           point_noise=0.2, seed=3)
    p = g.compile(pad_edges_to_multiple=world, dtype=F64, device=dev)
    p.data = shard_problem_data(p.data, mesh)
    chis = structure_only_refine(p, 5)
    out["structure_only"] = {
        "chi2": {t: [c.tolist() for c in v] for t, v in chis.items()},
        "estimates": _lists(p.estimates)}
    p = g.compile(pad_edges_to_multiple=world, bucket_landmarks=True,
                  dtype=F64, device=dev)
    out["cgls_bucketed"] = _step(
        p, g2o.CGLSSolver(max_iter=200, eta=1e-12), mesh, 1e-3)
    g2, truth = create_ba_scene(n_cameras=6, n_points=80, pixel_noise=0.5,
                                point_noise=0.2, seed=3)
    for j, vid in enumerate(truth):
        if j % 3 == 0:
            g2.set_marginalized(vid, False)
    p = g2.compile(pad_edges_to_multiple=world, dtype=F64, device=dev)
    out["implicit_general"] = _step(
        p, g2o.ImplicitSchurSolver(max_iter=150, tol=1e-10), mesh, 1e-3)
    for name, bucket, kw in (("implicit_rows", False, {}),
                             ("implicit_bucketed", True, {}),
                             ("implicit_runtime", False,
                              {"layout": "bucketed"})):
        p = g.compile(pad_edges_to_multiple=world, bucket_landmarks=bucket,
                      dtype=F64, device=dev)
        out[name] = _step(
            p, g2o.ImplicitSchurSolver(max_iter=30, tol=1e-10, **kw), mesh,
            1e-3)
    from g2o_tpu_torch.core.graph import Graph
    from g2o_tpu_torch.types import sba

    gm = mixed_sba_graph(*create_ba_scene(**MIXED_TEST_SCENE), Graph, sba)
    p = gm.compile(pad_edges_to_multiple=world, bucket_landmarks=True,
                   dtype=F64, device=dev)
    out["implicit_multi_observer"] = _step(
        p, g2o.ImplicitSchurSolver(max_iter=150, tol=1e-10), mesh, 1e-3)

    g = create_manhattan(n_poses=64, seed=21)
    p = g.compile(pad_edges_to_multiple=world, dtype=F64, device=dev)
    gmesh = make_global_mesh()
    out["multihost_step"] = _step(
        p, g2o.PCGSolver(max_iter=30, tol=1e-10), gmesh, 1e-4,
        data=shard_problem_data_global(p.data, gmesh))

    g = create_manhattan(n_poses=120, seed=3)
    p = g.compile(pad_edges_to_multiple=world, dtype=F64, device=dev)
    s = g2o.PCGSolver(max_iter=25, tol=1e-10, precond="chunk2",
                      chunk_size=8).setup(p)
    data = shard_problem_data(p.data, mesh)
    lin = p.linearize_fn(data, replicate_estimates(p.estimates, mesh))
    out["chunk2_solve"] = {"dx": s.solve(data, lin, 1e-3).tolist()}

    if args.g2o:
        from g2o_tpu_torch.io import g2o_format

        g = g2o_format.load(args.g2o)
    else:
        g = create_sphere(nodes_per_level=8, laps=3, radius=10.0, seed=4)
    p = g.compile(pad_edges_to_multiple=world, dtype=F64, device=dev)
    solvers = {"pcg": lambda: g2o.PCGSolver(max_iter=100, tol=1e-10),
               "dense": g2o.DenseSolver,
               "supernodal": g2o.SupernodalCholeskySolver,
               "sparse_chol": g2o.SparseCholeskySolver,
               "cgls": lambda: g2o.CGLSSolver(max_iter=200, eta=1e-12)}
    for name, make in solvers.items():
        out[f"sphere_{name}"] = _step(p, make(), mesh, 1e-3)
    est0 = replicate_estimates(p.estimates, mesh)
    p.data = shard_problem_data(p.data, mesh)
    p.estimates = dict(est0)
    res = g2o.optimize_gn_host(p, g2o.HostCholSolver(), 2)
    out["sphere_host_chol"] = {"chi2_per_iteration":
                               res["chi2_per_iteration"],
                               "estimates": _lists(p.estimates)}
    p.estimates = dict(est0)
    opt = g2o.SparseOptimizer(p, algorithm=g2o.Dogleg(),
                              solver=g2o.DenseSolver())
    opt.optimize(3)
    out["sphere_dogleg"] = {"chi2": opt.chi2()}

    out["multiprocess"] = case_multiprocess(args, world)
    return out


# --------------------------------------------------------------------- #
# chip_smoke.py's full-size cases
# --------------------------------------------------------------------- #

def _max_diff(a, b, rel=False):
    """Largest ``|a - b|`` over the vertex types (``rel``: over
    ``max(1, |b|)``)."""
    worst = 0.0
    for t in a:
        d = (a[t].double() - b[t].double()).abs()
        if rel:
            d = d / b[t].double().abs().clamp_min(1.0)
        worst = max(worst, float(d.max()))
    return worst


def _lm_run(args, p, est0, solver, iters):
    """A warm-up iteration, then ``iters`` LM iterations from ``est0`` with
    the kernel and all-reduce counts zeroed just before: the facts of the
    run and its launches."""
    p.estimates = {t: v.clone() for t, v in est0.items()}
    g2o.optimize_fused(p, solver, 1)
    p.estimates = {t: v.clone() for t, v in est0.items()}
    counted = hasattr(solver, "solves")   # CGLS counts its CG iterations
    if counted:
        solver.cg_iterations = solver.solves = 0
    _sync(args.device)
    _zero_counts()
    res = g2o.optimize_fused(p, solver, iters)
    _sync(args.device)
    trials = sum(res["trials_per_iteration"])
    cg = (solver.cg_iterations / max(solver.solves, 1) if counted
          else sum(res["cg_per_iteration"]) / max(trials, 1))
    return {"iterations": res["iterations"], "trials": trials,
            "chi2_first": res["chi2_per_iteration"][0],
            "chi2_final": res["chi2_final"],
            "cg_per_iteration": res["cg_per_iteration"],
            "cg_per_solve": cg,
            "ms_per_trial": res["wall_s"] * 1e3 / max(trials, 1),
            **_reduce_facts(trials)}, _counts()


def _reference(rank, fn):
    """``fn()`` on rank 0 alone (the unsharded computation), the other
    ranks waiting."""
    out = fn() if rank == 0 else None
    dist.barrier()
    return out


def case_sphere(args, world):
    """sphere2500 (Huber 1.0): one float64 step with chunk2 and jacobi PCG
    against the unsharded step; 5 float32 LM iterations of the main path's
    chunk2 PCG, unsharded and sharded."""
    from g2o_tpu_torch.io import g2o_format

    rank, dev = dist.get_rank(), args.device
    g = g2o_format.load(args.g2o)
    g.set_robust_kernel("Huber", 1.0)
    mesh = make_mesh()
    out, launches = {"world": world, "backend": dist.get_backend()}, {}
    p = g.compile(pad_edges_to_multiple=world, dtype=F64, device=dev)
    for precond in ("chunk2", "jacobi"):
        solver = g2o.PCGSolver(max_iter=25, tol=1e-10, precond=precond,
                               chunk_size=16).setup(p)
        step = make_fused_step(p, solver)
        ref = _reference(rank, lambda: step(p.data, p.estimates, 1e-4))
        e1, c1, _ = step(shard_problem_data(p.data, mesh),
                         replicate_estimates(p.estimates, mesh), 1e-4)
        if rank == 0:
            e0, c0, _ = ref
            out[f"step_{precond}"] = dict(
                max_abs_diff=_max_diff(e1, e0),
                chi2_rel_diff=abs(float(c1) - float(c0)) / float(c0),
                bit_equal=all(torch.equal(e0[t], e1[t]) for t in e0)
                and bool(torch.equal(c0, c1)))
    p = g.compile(pad_edges_to_multiple=world, dtype=torch.float32,
                  device=dev)
    est0 = {t: v.clone() for t, v in p.estimates.items()}

    def solver():
        return g2o.PCGSolver(max_iter=50, tol=1e-1, precond="chunk2",
                             chunk_size=16)

    ref = _reference(rank, lambda: _lm_run(args, p, est0, solver(),
                                           SPHERE_LM_ITERS)[0])
    if rank == 0:
        out["lm_unsharded"] = ref
    p.data = shard_problem_data(p.data, mesh)
    out["lm_sharded"], launches["sharded_sphere"] = _lm_run(
        args, p, replicate_estimates(est0, mesh), solver(), SPHERE_LM_ITERS)
    return out, launches


def case_manhattan(args, world):
    """``create_manhattan(n_poses, seed=7)``, float64, ``optimize_fused``
    with ``PCGSolver(max_iter=100, tol=1e-10)`` over the ``(hosts, edges)``
    mesh, against the one-process run."""
    rank = dist.get_rank()
    g = create_manhattan(n_poses=args.n_poses, seed=7)
    p = g.compile(pad_edges_to_multiple=world, dtype=F64,
                  device=args.device)
    est0 = {t: v.clone() for t, v in p.estimates.items()}
    keys = ("iterations", "chi2_per_iteration", "chi2_final",
            "cg_per_iteration", "wall_s")

    def run():
        res = g2o.optimize_fused(p, g2o.PCGSolver(max_iter=100, tol=1e-10),
                                 args.iters)
        _sync(args.device)
        return {k: res[k] for k in keys}

    ref = _reference(rank, run)
    mesh = make_global_mesh(hosts_axis=True)
    p.data = shard_problem_data_global(p.data, mesh)
    p.estimates = replicate_estimates(est0, mesh)
    _zero_counts()
    out = {"mesh_shape": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
           "one_process": ref, "sharded": run()}
    out["sharded"].update(_reduce_facts(out["sharded"]["iterations"]))
    return out, {"sharded_manhattan": _counts()}


def _load_bal(args, world, dtype, bucket=False):
    from g2o_tpu_torch.io import bal

    with gzip.open(args.bal, "rt") as fh:
        text = fh.read()
    return bal.load_bal_problem(io.StringIO(text), fix_first_camera=False,
                                dtype=dtype, device=args.device,
                                pad_edges_to_multiple=world,
                                bucket_landmarks=bucket)


def case_schur(args, world):
    """ladybug, ``SchurSolver(mesh=, use_pallas=True)``: one float64 solve
    against the unsharded solve; 10 float32 LM iterations, unsharded and
    sharded; this rank's K4 inputs saved to ``--out.k4.pt``."""
    rank = dist.get_rank()
    mesh = make_mesh()
    out, launches = {}, {}
    p = _load_bal(args, world, F64)
    s0 = g2o.SchurSolver(use_pallas=True).setup(p)
    ref = _reference(rank, lambda: s0.solve(
        p.data, p.linearize_fn(p.data, p.estimates), 1e-3))
    s1 = g2o.SchurSolver(mesh=mesh, use_pallas=True).setup(p)
    data = shard_problem_data(p.data, mesh)
    dx = s1.solve(data, p.linearize_fn(data, p.estimates), 1e-3)
    if rank == 0:
        out["step"] = dict(max_abs_diff=float((dx - ref).abs().max()),
                           n_pairs_rank=s1._layout["n_pairs"],
                           n_pairs=s0._layout["n_pairs"],
                           n_uniq=s1._layout["n_uniq"])
    p = _load_bal(args, world, torch.float32)
    est0 = {t: v.clone() for t, v in p.estimates.items()}
    ref = _reference(rank, lambda: _lm_run(
        args, p, est0, g2o.SchurSolver(use_pallas=True), args.iters)[0])
    if rank == 0:
        out["lm_unsharded"] = ref
    p.data = shard_problem_data(p.data, mesh)
    s = g2o.SchurSolver(mesh=mesh, use_pallas=True)
    out["lm_sharded"], launches["sharded_schur_ladybug"] = _lm_run(
        args, p, replicate_estimates(est0, mesh), s, args.iters)
    # K4's inputs at this rank's pairs, from the final linearization
    parts, aux = s._parts, s.aux
    lin = p.linearize_fn(p.data, p.estimates)
    B = parts["build_B"](p.data, lin)
    M = parts["pair_products"](B, parts["landmark_dinv"](lin, 1e-3, aux),
                               aux)
    if rank == 0:
        torch.save({"M": M, "ids": aux["pair_seg"],
                    "S": s._layout["n_uniq"]}, args.out + ".k4.pt")
    return out, launches


def case_implicit(args, world):
    """ladybug with ``bucket_landmarks=True``, ``ImplicitSchurSolver`` in
    its auto (dims-major) layout: one float64 step against the unsharded
    step; this rank's K5/K6 ids saved to ``--out.k56.pt``."""
    rank = dist.get_rank()
    mesh = make_mesh()
    p = _load_bal(args, world, F64, bucket=True)
    kw = dict(max_iter=100, tol=1e-2, precond="jacobi",
              matvec_precision="highest")
    solver = g2o.ImplicitSchurSolver(**kw).setup(p)
    step = make_fused_step(p, solver)
    ref = _reference(rank, lambda: step(p.data, p.estimates, 1e-3))
    data = shard_problem_data(p.data, mesh)
    est = replicate_estimates(p.estimates, mesh)
    _sync(args.device)
    _zero_counts()
    t0 = time.perf_counter()
    e1, c1, _ = step(data, est, 1e-3)
    _sync(args.device)
    secs = time.perf_counter() - t0
    launches = {"sharded_implicit_ladybug": _counts()}
    out = {"layout": solver._layout["form"], "step_ms": secs * 1e3,
           **_reduce_facts(1)}
    if rank == 0:
        e0, c0, _ = ref
        out.update(max_rel_diff=_max_diff(e1, e0, rel=True),
                   chi2_rel_diff=abs(float(c1) - float(c0)) / float(c0))
        (name, spec), = p.bucket_specs.items()
        lo, n = problem_mod.row_window(data, name)
        m = max(0, min(n, spec.n_rows - lo))
        torch.save({"ids": data.plans[name]["ids32"][spec.pose_slot, :m]
                    .contiguous(),
                    "S": p.counts["VERTEX_CAMERA_BAL"]},
                   args.out + ".k56.pt")
    return out, launches


def _bucketed_lm(args, rank, mesh, p, make_solver, iters):
    """``iters`` float32 LM iterations of ``make_solver()``: unsharded on
    rank 0, then sharded.  ``({"lm_unsharded", "lm_sharded"}, this rank's
    launches of the sharded run)``."""
    est0 = {t: v.clone() for t, v in p.estimates.items()}
    ref = _reference(rank, lambda: _lm_run(args, p, est0, make_solver(),
                                           iters)[0])
    p.data = shard_problem_data(p.data, mesh)
    res, launches = _lm_run(args, p, replicate_estimates(est0, mesh),
                            make_solver(), iters)
    out = {"lm_sharded": res}
    if rank == 0:
        out["lm_unsharded"] = ref
    return out, launches


def _step_pair(p, solver, mesh, rank, lam=1e-3):
    """One float64 fused step unsharded (rank 0) and sharded, each with the
    chi2 at the stepped estimates: the facts on rank 0, and the sharded
    data."""
    step = make_fused_step(p, solver)

    def run(data, est):
        e, _, _ = step(data, est, lam)
        return e, p.chi2_fn(data, e)[0]

    ref = _reference(rank, lambda: run(p.data, p.estimates))
    data = shard_problem_data(p.data, mesh)
    e1, c1 = run(data, replicate_estimates(p.estimates, mesh))
    facts = {"form": solver._layout["form"]} if hasattr(solver,
                                                        "_layout") else {}
    if rank == 0:
        facts.update(max_rel_diff=_max_diff(e1, ref[0], rel=True),
                     chi2_rel_diff=abs(float(c1) - float(ref[1]))
                     / abs(float(ref[1])))
    return facts, data


def _save_ids(args, rank, tag, body):
    """Rank 0's kernel inputs of a path, for ``chip_smoke.py`` to hold and
    time the kernels at one rank's shapes."""
    if rank == 0 and args.out:
        torch.save(body, f"{args.out}.{tag}.pt")


def case_runtime(args, world):
    """ladybug built without ``bucket_landmarks``, ``ImplicitSchurSolver(
    layout="bucketed")`` (the runtime-bucketed form, K7/K8): one float64
    step against the unsharded step; ``--iters`` float32 LM iterations,
    unsharded and sharded; rank 0's held camera ids saved to
    ``--out.k78.pt``."""
    rank = dist.get_rank()
    mesh = make_mesh()
    kw = dict(max_iter=100, tol=1e-2, precond="jacobi", layout="bucketed")
    p = _load_bal(args, world, F64)
    solver = g2o.ImplicitSchurSolver(**kw).setup(p)
    out, data = _step_pair(p, solver, mesh, rank)
    name, = p.edge_types
    _save_ids(args, rank, "k78", {
        "ids": solver._rows_here(data, name)[2],
        "S": p.counts["VERTEX_CAMERA_BAL"], "widths": (9, 81)})
    p = _load_bal(args, world, torch.float32)
    lm, launches = _bucketed_lm(args, rank, mesh, p,
                                lambda: g2o.ImplicitSchurSolver(**kw),
                                args.iters)
    out.update(lm)
    return out, {"sharded_runtime_ladybug": launches}


def case_cgls(args, world):
    """ladybug with ``bucket_landmarks=True``, ``CGLSSolver`` (K5/K6 on the
    camera slot): one float64 solve against the unsharded solve;
    ``--iters`` float32 LM iterations, unsharded and sharded; rank 0's
    camera ids saved to ``--out.k56c.pt``."""
    rank = dist.get_rank()
    mesh = make_mesh()
    kw = dict(max_iter=200, eta=1e-4)
    p = _load_bal(args, world, F64, bucket=True)
    solver = g2o.CGLSSolver(**kw).setup(p)
    ref = _reference(rank, lambda: solver.solve(
        p.data, p.linearize_fn(p.data, p.estimates), 1e-3))
    data = shard_problem_data(p.data, mesh)
    dx = solver.solve(data, p.linearize_fn(data, p.estimates), 1e-3)
    out = {}
    if rank == 0:
        out["dx_rel_diff"] = float((dx - ref).norm() / ref.norm())
    (name, spec), = p.bucket_specs.items()
    _save_ids(args, rank, "k56c", {
        "ids": data.plans[name]["ids32"][spec.pose_slot].contiguous(),
        "S": p.counts["VERTEX_CAMERA_BAL"]})
    p = _load_bal(args, world, torch.float32, bucket=True)
    lm, launches = _bucketed_lm(args, rank, mesh, p,
                                lambda: g2o.CGLSSolver(**kw), args.iters)
    out.update(lm)
    return out, {"sharded_cgls_ladybug": launches}


def case_mixed_sba(args, world):
    """The mixed mono/stereo map (:func:`mixed_sba_graph`) on
    ``create_ba_scene(*--sba-scene)`` with ``bucket_landmarks=True``,
    ``ImplicitSchurSolver`` (the multi-observer form, K7/K8): one float64
    step against the unsharded step; ``--sba-iters`` float32 LM
    iterations, unsharded and sharded; rank 0's held camera ids per batch
    saved to ``--out.k78m.pt``."""
    from g2o_tpu_torch.core.graph import Graph
    from g2o_tpu_torch.types import sba

    rank = dist.get_rank()
    mesh = make_mesh()
    nc, npt, seed = (int(x) for x in args.sba_scene.split(","))
    g = mixed_sba_graph(*create_ba_scene(n_cameras=nc, n_points=npt,
                                         seed=seed), Graph, sba)
    kw = dict(max_iter=150, tol=1e-8)
    p = g.compile(pad_edges_to_multiple=world, bucket_landmarks=True,
                  dtype=F64, device=args.device)
    solver = g2o.ImplicitSchurSolver(**kw).setup(p)
    out, data = _step_pair(p, solver, mesh, rank)
    _save_ids(args, rank, "k78m", {
        "ids": {name: solver._rows_here(data, name)[2]
                for name in p.bucket_specs},
        "S": p.counts["VERTEX_SE3:EXPMAP"], "widths": (6, 36)})
    p = g.compile(pad_edges_to_multiple=world, bucket_landmarks=True,
                  dtype=torch.float32, device=args.device)
    lm, launches = _bucketed_lm(args, rank, mesh, p,
                                lambda: g2o.ImplicitSchurSolver(**kw),
                                args.sba_iters)
    out.update(lm)
    return out, {"sharded_mixed_sba": launches}


CASES = {"multiprocess": case_multiprocess, "tests": case_tests,
         "sphere": case_sphere, "manhattan": case_manhattan,
         "schur": case_schur, "implicit": case_implicit,
         "runtime": case_runtime, "cgls": case_cgls,
         "mixed_sba": case_mixed_sba}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--init-method", required=True,
                    help="tcp://HOST:PORT of rank 0's store")
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    ap.add_argument("--case", default="multiprocess")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--sba-iters", type=int, default=15,
                    help="the mixed_sba case's LM iterations")
    ap.add_argument("--sba-scene", default="49,7000,0",
                    help="the mixed_sba case's create_ba_scene n_cameras, "
                    "n_points, seed")
    ap.add_argument("--n-poses", type=int, default=200)
    ap.add_argument("--g2o", default="", help="the sphere case's .g2o file")
    ap.add_argument("--bal", default="", help="the BA cases' BAL file")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        torch.cuda.set_device(args.pid % torch.cuda.device_count())
    initialize_distributed(num_processes=args.nproc, process_id=args.pid,
                           init_method=args.init_method,
                           backend=args.backend)
    rank, world = dist.get_rank(), dist.get_world_size()
    results, launches = {}, {}
    for case in args.case.split(","):
        t0 = time.perf_counter()
        res = CASES[case](args, world)
        if isinstance(res, tuple):
            res, counts = res
            launches.update(counts)
        res["seconds"] = time.perf_counter() - t0
        results[case] = res
    dist.barrier()
    if args.out:
        if rank == 0:
            body = (results["multiprocess"] if args.case == "multiprocess"
                    else results)
            path = args.out
        else:
            body, path = {}, f"{args.out}.rank{rank}"
        with open(path, "w") as fh:
            json.dump({**body, "launches": launches, "rank": rank}, fh)
    print(json.dumps({"pid": args.pid, "rank": rank, "cases": args.case}),
          flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
