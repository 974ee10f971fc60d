"""Closed forms on tiny SPD blocks — port of
``g2o_tpu/ops/smallblocks.py``: ``chol_small`` (the square-root CGLS
solver's whitening factor), ``inv_small`` (the block-Jacobi
preconditioner's per-vertex inverse) and ``inv_small_t`` (its dims-major
twin); and ``cholesky_or_nan``, the port's one Cholesky with the JAX
package's failure mode."""

from __future__ import annotations

import torch

from g2o_tpu_torch.utils.tictoc import span


def cholesky_or_nan(A):
    """Lower Cholesky factor of SPD ``A (..., n, n)``; a matrix that is not
    positive definite gets a NaN factor, as ``jnp.linalg.cholesky`` gives
    it, on the device and without a host read (an LM trial then fails
    instead of raising)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info[..., None, None] == 0, L, torch.nan)


def chol_small(A):
    """Lower Cholesky factor of SPD blocks (..., r, r): closed form for r
    in {1, 2, 3} (the JAX package's formulas), :func:`cholesky_or_nan`
    above.  A block that is not positive definite gives NaN on either
    route, as the JAX package's square roots and Cholesky do."""
    r = A.shape[-1]
    if r == 1:
        return torch.sqrt(A)
    if r == 2:
        a = torch.sqrt(A[..., 0, 0])
        b = A[..., 1, 0] / a
        c = torch.sqrt(A[..., 1, 1] - b * b)
        z = torch.zeros_like(a)
        return torch.stack([
            torch.stack([a, z], dim=-1),
            torch.stack([b, c], dim=-1),
        ], dim=-2)
    if r == 3:
        l11 = torch.sqrt(A[..., 0, 0])
        l21 = A[..., 1, 0] / l11
        l31 = A[..., 2, 0] / l11
        l22 = torch.sqrt(A[..., 1, 1] - l21 * l21)
        l32 = (A[..., 2, 1] - l31 * l21) / l22
        l33 = torch.sqrt(A[..., 2, 2] - l31 * l31 - l32 * l32)
        z = torch.zeros_like(l11)
        return torch.stack([
            torch.stack([l11, z, z], dim=-1),
            torch.stack([l21, l22, z], dim=-1),
            torch.stack([l31, l32, l33], dim=-1),
        ], dim=-2)
    return cholesky_or_nan(A)


def inv_small(A):
    """Inverse of SPD blocks (..., r, r): closed form for r in {1, 2, 3}
    (the same formulas as the JAX package, for exactness parity),
    Cholesky-based for larger r (NaN for a block that is not positive
    definite)."""
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
    L = cholesky_or_nan(A)
    # torch checks the inverse's info on the host: one device read a call
    with span("read.cholesky_inverse"):
        return torch.cholesky_inverse(L)


def inv_small_t(At):
    """DIMS-MAJOR twin of :func:`inv_small`: blocks ``(r, r, ...)`` with the
    batch axes LAST (the implicit Schur solver keeps its landmark blocks
    with the segment axis last, as its linearization produces them).  The
    same formulas, applied to a view with the block axes moved last."""
    return torch.movedim(inv_small(torch.movedim(At, (0, 1), (-2, -1))),
                         (-2, -1), (0, 1))
