"""Multi-process execution over ``torch.distributed`` — port of
``g2o_tpu/parallel``: one process per rank, the edge rows of every batch
split over the ranks, estimates replicated, each sum over edges completed
by an all-reduce (``core/problem.py``)."""

from g2o_tpu_torch.parallel.multihost import (
    HOST_AXIS,
    edge_partition_spec,
    initialize_distributed,
    make_global_mesh,
    shard_problem_data_global,
)
from g2o_tpu_torch.parallel.sharded import (
    EDGE_AXIS,
    make_fused_step,
    make_mesh,
    replicate_estimates,
    shard_problem_data,
)

__all__ = [
    "EDGE_AXIS",
    "HOST_AXIS",
    "edge_partition_spec",
    "initialize_distributed",
    "make_fused_step",
    "make_global_mesh",
    "make_mesh",
    "replicate_estimates",
    "shard_problem_data",
    "shard_problem_data_global",
]
