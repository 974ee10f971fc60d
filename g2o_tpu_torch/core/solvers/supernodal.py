"""Batched dense factor/solve dispatch — port of ``_chol_batched`` and
``_solve_lower_batched`` of ``g2o_tpu/core/solvers/supernodal.py``.

Up to 96 columns (the JAX package's ``_SAFE_XLA_DIM``: there XLA did the
work outside Pallas) the batch goes to ``torch.linalg``.  Past 96 columns,
when the size is a multiple of the block width ``d``, it goes to the Hopper
kernels K1/K2 of :mod:`g2o_tpu_torch.ops.chol_kernels` — the launch on a
CUDA tensor, their plain version on a CPU tensor.  The TPU's d-blocked
emulation and its VMEM guard have no counterpart here: the kernels take any
size.
"""

from __future__ import annotations

import torch

from g2o_tpu_torch.ops import chol_kernels

_SAFE_XLA_DIM = 96


def _chol_batched(D, d: int):
    """Batched lower Cholesky of ``(S, sd, sd)``."""
    sd = D.shape[-1]
    if sd <= _SAFE_XLA_DIM or sd % d:
        return torch.linalg.cholesky(D)
    return chol_kernels.chol_batched(D.contiguous())


def _solve_lower_batched(L, B, d: int):
    """Solve ``L Y = B`` with ``L (S, sd, sd)`` lower, ``B (S, sd, m)``."""
    sd = L.shape[-1]
    if sd <= _SAFE_XLA_DIM or sd % d:
        return torch.linalg.solve_triangular(L, B, upper=False)
    return chol_kernels.solve_lower_batched(L.contiguous(), B.contiguous())
