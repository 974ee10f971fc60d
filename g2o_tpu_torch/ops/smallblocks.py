"""Closed-form inverses of tiny SPD blocks — port of
``g2o_tpu/ops/smallblocks.py::inv_small`` (the block-Jacobi
preconditioner's per-vertex inverse)."""

from __future__ import annotations

import torch


def inv_small(A):
    """Inverse of SPD blocks (..., r, r): closed form for r in {1, 2, 3}
    (the same formulas as the JAX package, for exactness parity),
    Cholesky-based for larger r."""
    r = A.shape[-1]
    if r == 1:
        return 1.0 / A
    if r == 2:
        a, b = A[..., 0, 0], A[..., 0, 1]
        c, d = A[..., 1, 0], A[..., 1, 1]
        inv_det = 1.0 / (a * d - b * c)
        return torch.stack([
            torch.stack([d, -b], dim=-1),
            torch.stack([-c, a], dim=-1),
        ], dim=-2) * inv_det[..., None, None]
    if r == 3:
        a = A
        c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
        c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
        c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
        det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
        inv_det = 1.0 / det
        c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
        c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
        c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
        c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
        c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
        c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
        M = torch.stack([
            torch.stack([c00, c10, c20], dim=-1),
            torch.stack([c01, c11, c21], dim=-1),
            torch.stack([c02, c12, c22], dim=-1),
        ], dim=-2)
        return M * inv_det[..., None, None]
    return torch.cholesky_inverse(torch.linalg.cholesky(A))
