"""Edge-sharded execution over ``torch.distributed`` — port of
``g2o_tpu/parallel/sharded.py``.

The reference's only parallelism is shared-memory OpenMP loops over edges
with per-vertex mutexes (``g2o/core/sparse_optimizer.cpp:72-78``,
``block_solver.hpp:482-506``).  Here one process per rank holds one
contiguous slice of the rows of every edge batch; vertex estimates, fixed
masks, offsets and the assembled gradient and Hessian are replicated.  The
JAX package leaves the per-vertex sums of sharded edge batches to XLA's
partitioner; PyTorch has none, so each of them is this process's partial
sum completed by an explicit ``all_reduce(SUM)`` (``edge_sum_`` in
``core/problem.py``).  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks.

Usage, in every process of the group::

    initialize_distributed(...)            # or torchrun's environment
    p = g.compile(pad_edges_to_multiple=world, device=...)
    mesh = make_mesh()
    p.data = shard_problem_data(p.data, mesh)
    p.estimates = replicate_estimates(p.estimates, mesh)
    optimize_fused(p, PCGSolver(), 10)     # every rank the same numbers
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from g2o_tpu_torch.core.problem import (PLAN_EDGE_AXIS, EdgeBatchData,
                                        ProblemData)

EDGE_AXIS = "edges"


def mesh_device_type():
    """The device type a mesh records: ``cuda`` under NCCL, else ``cpu``
    (Gloo stages CUDA tensors through the host itself)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: int | None = None, axis: str = EDGE_AXIS):
    """A 1-D mesh named ``axis`` over the first ``n_devices`` ranks (all of
    them by default) of the default group, which is brought up as a world
    of one when it is not up yet (:func:`initialize_distributed`)."""
    from g2o_tpu_torch.parallel.multihost import initialize_distributed

    initialize_distributed()
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 0 < n <= world:
        raise ValueError(f"make_mesh: {n} devices in a world of {world}")
    return DeviceMesh(mesh_device_type(), torch.arange(n),
                      mesh_dim_names=(axis,))


def mesh_group(mesh, axis: str | None = None):
    """The process group of mesh dimension ``axis``; with ``axis=None`` the
    group of the whole mesh (its dimensions flattened, the first
    outermost)."""
    if axis is not None:
        return mesh.get_group(axis)
    if mesh.ndim == 1:
        return mesh.get_group(0)
    if mesh.size() == dist.get_world_size():
        return dist.group.WORLD
    raise NotImplementedError("a multi-dimensional mesh over part of the "
                              "world")


def shard_rows(data: ProblemData, group) -> ProblemData:
    """This process's contiguous row slice ``[r·n, (r+1)·n)`` of every edge
    batch (its rows, free masks and per-edge plan tensors, copied so that
    the full batch can be freed); everything else as it is.  The row
    count of every batch must divide the group's size: compile with
    ``pad_edges_to_multiple=world`` (padding rows are inactive)."""
    if data.group is not None:
        raise ValueError("the problem data is sharded already")
    rank, world = dist.get_rank(group), dist.get_world_size(group)

    def rows(x, axis=0):
        n = x.shape[axis]
        if n % world:
            raise ValueError(
                f"an edge batch of {n} rows does not divide over {world} "
                f"processes: compile with pad_edges_to_multiple={world}")
        per = n // world
        return x.narrow(axis, rank * per, per).clone(
            memory_format=torch.contiguous_format)

    return data._replace(
        edges={k: EdgeBatchData(*(rows(x) for x in b))
               for k, b in data.edges.items()},
        free_mask={k: rows(v) for k, v in data.free_mask.items()},
        plans={k: {kk: rows(vv, PLAN_EDGE_AXIS[kk])
                   if kk in PLAN_EDGE_AXIS else vv for kk, vv in d.items()}
               for k, d in data.plans.items()},
        group=group)


def shard_problem_data(data: ProblemData, mesh,
                       axis: str = EDGE_AXIS) -> ProblemData:
    """Split the edge batches over mesh dimension ``axis`` (the mesh's
    processes along the other dimensions hold the same rows); everything
    else replicated.  Edge counts must divide the axis size (use
    ``compile(..., pad_edges_to_multiple=n_devices)``)."""
    return shard_rows(data, mesh_group(mesh, axis))


def replicate_estimates(estimates: dict, mesh) -> dict:
    """The estimates of the mesh's first process on every process of the
    mesh (one broadcast per vertex type); copies, the input is kept."""
    group = mesh_group(mesh)
    src = dist.get_global_rank(group, 0)
    out = {}
    for t, v in estimates.items():
        out[t] = v.clone(memory_format=torch.contiguous_format)
        dist.broadcast(out[t], src, group=group)
    return out


def fresh_solve(solver, data, lin, lam):
    """One solve with the solver's initial state (no residual floor carried
    from an earlier solve): the JAX package's ``solver._solve_fn``."""
    args = (data, lin, lam) + ((solver.aux,) if hasattr(solver, "aux")
                               else ())
    out = solver._solve_fn(*args)
    return out[0] if isinstance(out, tuple) else out


def make_fused_step(problem, solver, *, donate: bool = True):
    """One full optimization step: linearize → solve(λ) → apply.  Returns
    ``run(data, estimates, lam) -> (new_estimates, chi2_robust, chi2)``
    (the chi2 of ``estimates``).  Works in one process or sharded (pass
    sharded ``data`` and replicated ``estimates``).  ``solver`` must be set
    up for ``problem``.

    ``donate`` is accepted for the JAX package's signature: there it lets
    the step reuse the estimates' device buffers; here a step always
    returns new tensors and leaves ``estimates`` as they were."""
    del donate

    def run(data, estimates, lam):
        lin = problem.linearize_fn(data, estimates)
        dx = fresh_solve(solver, data, lin, lam)
        return (problem.apply_update_fn(data, estimates, dx),
                lin.chi2_robust, lin.chi2)

    return run
