#!/usr/bin/env python3
"""Phase 15's landmark-bucketed sharded runs of ``chip_smoke.py`` alone.

    python3 scripts/smoke_bucketed_sharded.py

Builds the kernels, spawns the worker as two Gloo ranks on ``cuda:0`` and
as one NCCL rank with ``--case runtime,cgls,mixed_sba``, holds and times
K5/K6 and K7/K8 at the ids rank 0 handed them, then prints
``[sharded_runtime_ladybug]``, ``[sharded_cgls_ladybug]`` and
``[sharded_mixed_sba]`` with their bars, as the whole script does, and
``[done]`` with the seconds.  About two and a half minutes on one H100,
against the whole script's ten.
"""

import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

CASES = ",".join(cs.BUCKETED_RUNS)


def main():
    t0 = time.perf_counter()
    cs.device_phase(torch)
    from g2o_tpu_torch.ops import chol_kernels as ck
    from g2o_tpu_torch.ops import onehot as oh
    from g2o_tpu_torch.ops import segment_kernels as sk

    ck.build()
    ck._load()
    sk._load()
    oh._load()
    with tempfile.TemporaryDirectory() as tmp:
        res, ranks = cs._spawn_workers(cs.PARALLEL_WORLD, "gloo", CASES,
                                       os.path.join(tmp, "gloo.json"))
        nccl, nccl_ranks = cs._spawn_workers(1, "nccl", CASES,
                                             os.path.join(tmp, "nccl.json"))
        k56c, k78 = cs.bucketed_kernel_inputs(torch, tmp)
    rng = np.random.default_rng(15)
    cs.dims_major_kernel_rows(torch, oh, rng, *k56c)
    for ids, S, widths, tag in k78:
        cs.rowmajor_kernel_rows(torch, oh, rng, ids, S, widths, tag)
    by_path = cs.bucketed_runs(res, nccl, ranks, nccl_ranks)
    cs.phase("done", seconds=f"{time.perf_counter() - t0:.1f}",
             paths=",".join(by_path))


if __name__ == "__main__":
    main()
