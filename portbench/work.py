"""The work a solve needs, counted from the problem's sizes, and the peaks
it is held against.

Bytes count each input read once and each output written once, in float32
(4 bytes) with int32 indices; what a CG iteration must read again (the
observation blocks and indices, far larger than the 50 MB L2 cache at
these sizes) counts again each iteration.  Operations count a multiply-add
as two, as the peak rate does.  A roofline share is the least time, the
larger of bytes over the memory rate and operations over the float32 rate,
over the measured device time.
"""

from __future__ import annotations

# published peaks of the SXM part (NVIDIA's data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores, at the 700 W limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_s": 3.35e12, "f32_ops_s": 67e12},
}

F32, IDX = 4, 4
DP, DL = 9, 3                    # camera and point tangent widths


def least_seconds(nbytes, ops, device_name):
    """The least time for ``nbytes`` and ``ops`` on ``device_name``, or
    None for a card the table lacks."""
    peak = PEAKS.get(device_name)
    if peak is None:
        return None
    return max(nbytes / peak["bytes_s"], ops / peak["f32_ops_s"])


def implicit_solve(C, P, O, cg_iterations):
    """``(bytes, ops)`` of a point-eliminated PCG solve taking
    ``cg_iterations`` products S v: per solve the landmark inverses, the
    reduced right-hand side, the camera blocks of S (the preconditioner)
    and the point back-substitution; per iteration B^T u, D^-1 t and B s
    over every observation with the camera blocks applied twice."""
    B, ids = DP * DL * O * F32, O * IDX
    dinv = DL * DL * P * F32
    cam_blocks = DP * DP * C * F32
    vectors = (DL * P + DP * C) * F32
    # in: B, camera ids, Hp, Hc, b; out: D^-1 (read by every iteration),
    # the preconditioner's inverse blocks, dx
    per_solve_bytes = B + ids + dinv + cam_blocks + vectors \
        + dinv + cam_blocks + vectors
    per_iter_bytes = B + ids + dinv + 2 * cam_blocks
    per_solve_ops = (O * (2 * DP * DL            # B y (rhs)
                          + 2 * DP * DL * DL + 2 * DP * DL * DP  # B D^-1 B^T
                          + 2 * DP * DL)         # B^T dxc (back-substitution)
                     + P * (2 * DL ** 3 + 2 * 2 * DL * DL)  # D^-1, D^-1 b
                     + C * 2 * DP ** 3)          # the preconditioner's inverse
    per_iter_ops = (O * 4 * DP * DL + P * 2 * DL * DL
                    + C * 4 * DP * DP + C * DP * 10)
    return (per_solve_bytes + cg_iterations * per_iter_bytes,
            per_solve_ops + cg_iterations * per_iter_ops)


def explicit_solve(C, P, O, unordered_pairs):
    """``(bytes, ops)`` of a point-eliminated dense solve: the blocks B =
    Jc^T W Jp from the Jacobians, B D^-1 per observation, one product per
    unordered pair of observations of a point (S is symmetric) and its sum
    into S, the Cholesky factor of the (9C)-wide S and its two triangular
    solves, the back-substitution."""
    n = DP * C
    tri = n * (n + 1) // 2
    jac = (2 * DP + 2 * DL + 4) * O * F32       # Jc, Jp, W
    nbytes = (jac + 2 * O * IDX
              + DL * DL * P * F32 * 2            # Hp in, D^-1 (kept)
              + DP * DP * C * F32                # camera diagonal blocks in
              + (DL * P + DP * C) * F32 * 2      # b in, dx out
              + tri * F32 * 5)                   # S out, factor in and out,
    #                                              two triangular solves
    ops = (O * (2 * (2 * 2 * DL + DP * 2 * DL)   # B
                + 2 * DP * DL * DL               # B D^-1
                + 2 * 2 * DP * DL)               # rhs and back-substitution
           + unordered_pairs * (2 * DP * DL * DP + DP * DP)
           + n ** 3 / 3 + 2 * n * n
           + P * (2 * DL ** 3 + 2 * 2 * DL * DL))
    return nbytes, ops
