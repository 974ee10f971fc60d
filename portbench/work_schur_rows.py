"""The work of the Schur term of one implicit Schur product S v, counted
from the problem's sizes, for the Schur rows kernels' roofline share.

The term is, per camera, the sum over its observations of B_e D^-1_k
sum_{f of k} B_f^T v[cam_f], k the observation's point.  The least work
reads B once (its 27 values an observation), the camera ids, the points'
D^-1 and v, and writes the (C, 9) result; per observation it takes B^T u
and B s (2 x 27 multiply-adds), the point's sum of B^T u (3 adds) and the
camera's sum of B s (9 adds); per point D^-1 t (9 multiply-adds).  What an
implementation writes and reads beyond that (the tiled form's per-row B s
in camera order) is not counted.  Bytes and operations as in ``work.py``.
"""

from __future__ import annotations

from portbench.work import DL, DP, F32, IDX, least_seconds


def schur_rows(C, P, O):
    """``(bytes, ops)`` of one S v Schur term over ``O`` observations of
    ``P`` points by ``C`` cameras."""
    nbytes = (DP * DL * O * F32 + O * IDX + DL * DL * P * F32
              + 2 * DP * C * F32)
    ops = O * (2 * 2 * DP * DL + DL + DP) + P * 2 * DL * DL
    return nbytes, ops


def schur_rows_seconds(C, P, O, calls, device_name):
    """The least time of ``calls`` such terms on ``device_name``, or None
    for a card ``work.PEAKS`` lacks."""
    nbytes, ops = schur_rows(C, P, O)
    return least_seconds(calls * nbytes, calls * ops, device_name)
