"""Multi-host helpers over ``torch.distributed`` — port of
``g2o_tpu/parallel/multihost.py``.

1. every process calls :func:`initialize_distributed` (an address, the
   process count and this process's rank; or nothing under ``torchrun``,
   whose environment names them; or nothing at all for a world of one);
2. :func:`make_global_mesh` builds a mesh over every rank — 1-D
   (``edges``), or 2-D (``hosts × edges``) with the host axis outermost;
3. :func:`shard_problem_data_global` keeps on each process only its own
   edge rows: process ``p`` of ``P`` owns rows ``[p·n, (p+1)·n)`` of every
   batch, the host axis outermost.

Unlike the JAX package, whose ``initialize_distributed`` swallows every
error of the runtime's start, a launch that names its group explicitly and
fails to start it raises: a wrong address or process count does not run
quietly as a world of one.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from g2o_tpu_torch.core.problem import ProblemData
from g2o_tpu_torch.parallel.sharded import (EDGE_AXIS, mesh_device_type,
                                            mesh_group, shard_rows)

HOST_AXIS = "hosts"


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           local_device_ids=None, *, backend=None,
                           init_method: str | None = None) -> None:
    """Bring up the default process group (a no-op when it is up).

    ``backend``: NCCL when a CUDA card is visible, else Gloo (Gloo also
    reduces CUDA tensors, staging them through the host).  With an
    address (``tcp://coordinator_address``) or ``init_method``, and
    ``num_processes`` / ``process_id``, the group is that one and a failure
    to start it raises.  With no argument: ``torchrun``'s environment when
    ``RANK`` and ``WORLD_SIZE`` are set, else a world of one.
    ``local_device_ids``: the first id becomes this process's CUDA
    device."""
    if dist.is_initialized():
        return
    if local_device_ids is not None and torch.cuda.is_available():
        torch.cuda.set_device(int(list(local_device_ids)[0]))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    if coordinator_address is not None and init_method is None:
        init_method = f"tcp://{coordinator_address}"
    if init_method is not None or kw:
        if init_method is None:
            raise ValueError("initialize_distributed: num_processes / "
                             "process_id need coordinator_address or "
                             "init_method")
        dist.init_process_group(backend, init_method=init_method, **kw)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)            # torchrun: env://
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def make_global_mesh(*, hosts_axis: bool = False):
    """A mesh over every rank of the default group (brought up as a world
    of one when it is not up).  ``hosts_axis=False``: 1-D ``(edges,)``.
    ``hosts_axis=True``: 2-D ``(hosts, edges)``, the host axis outermost;
    a host is ``LOCAL_WORLD_SIZE`` consecutive ranks (``torchrun``'s node),
    and a process started without it is a host of its own, as a JAX
    process is."""
    initialize_distributed()
    world = dist.get_world_size()
    ranks = torch.arange(world)
    if not hosts_axis:
        return DeviceMesh(mesh_device_type(), ranks,
                          mesh_dim_names=(EDGE_AXIS,))
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    if world % per_host:
        raise ValueError(f"{world} ranks do not split into hosts of "
                         f"{per_host}")
    return DeviceMesh(mesh_device_type(),
                      ranks.reshape(world // per_host, per_host),
                      mesh_dim_names=(HOST_AXIS, EDGE_AXIS))


def edge_partition_spec(mesh) -> tuple:
    """The mesh dimensions the edge axis is split over: all of them, the
    first outermost (PyTorch has no ``PartitionSpec``; these are its
    names)."""
    return tuple(mesh.mesh_dim_names)


def shard_problem_data_global(data: ProblemData, mesh) -> ProblemData:
    """Split the edge batches over every dimension of ``mesh``: each
    process keeps only its own rows (process ``p`` of ``P`` owns
    ``[p·n, (p+1)·n)``, the host axis outermost); everything else
    replicated."""
    return shard_rows(data, mesh_group(mesh))
