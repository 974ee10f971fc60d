"""Plain BAL bundle adjustment: projection, robust linearization, chi2.

Written from the BAL camera model (Agarwal et al., ECCV 2010,
grail.cs.washington.edu/projects/bal): a camera is [Rodrigues rotation
(3), translation (3), f, k1, k2]; a world point X maps to P = R X + t,
p = -P_xy / P_z, uv = f (1 + k1 |p|^2 + k2 |p|^4) p.  Cameras and points
update additively.  The residual is uv - z with identity information; the
robust kernel is Huber of width delta on s = e^T e: rho(s) = s for
s <= delta^2, else 2 delta sqrt(s) - delta^2, and the weight is rho'(s).

Observations are ``Obs(cam, pt, uv)``: camera and point index per row and
the measured pixel.  Estimates are ``(cams (C, 9), pts (P, 3))`` in the
index order of ``Obs``.

Imports torch alone.  ``Arith(dtype, tf32=True)`` rounds both operands of
every product of the linear algebra to TF32 (10 mantissa bits) and sums
in ``dtype``: the control a float32 program has to beat.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

ROWS_PER_BLOCK = 1 << 20


class Obs(NamedTuple):
    cam: torch.Tensor      # (O,) int64
    pt: torch.Tensor       # (O,) int64
    uv: torch.Tensor       # (O, 2) float32, the measured pixels


def round_tf32(x):
    """``x`` (float32) with its mantissa rounded to TF32's 10 bits."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


class Arith:
    """The working dtype, and whether products take TF32 operands."""

    def __init__(self, dtype=torch.float64, tf32=False):
        if tf32 and dtype != torch.float32:
            raise ValueError("TF32 rounds float32 operands")
        self.dtype = dtype
        self.tf32 = tf32

    def ein(self, spec, *ops):
        if self.tf32:
            ops = tuple(round_tf32(o.contiguous()) for o in ops)
        return torch.einsum(spec, *ops)


def rotate(w, X):
    """Rotate ``X`` by the angle-axis vector ``w`` (Rodrigues' formula;
    the first-order form below an angle of 1e-7)."""
    th2 = torch.sum(w * w, dim=-1, keepdim=True)
    small = th2 < 1e-14
    th = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    k = w / th
    c, s = torch.cos(th), torch.sin(th)
    full = (X * c + torch.linalg.cross(k, X) * s
            + k * torch.sum(k * X, dim=-1, keepdim=True) * (1.0 - c))
    return torch.where(small, X + torch.linalg.cross(w, X), full)


def project(cam, X):
    """Pixel of world point ``X`` (..., 3) in camera ``cam`` (..., 9)."""
    P = rotate(cam[..., 0:3], X) + cam[..., 3:6]
    p = -P[..., 0:2] / P[..., 2:3]
    r2 = torch.sum(p * p, dim=-1, keepdim=True)
    radial = 1.0 + cam[..., 7:8] * r2 + cam[..., 8:9] * r2 * r2
    return cam[..., 6:7] * radial * p


def huber(s, delta):
    """(rho(s), rho'(s)) of the Huber kernel."""
    inside = s <= delta * delta
    root = torch.sqrt(torch.clamp_min(s, 1e-300))
    rho = torch.where(inside, s, 2.0 * delta * root - delta * delta)
    w = torch.where(inside, torch.ones_like(s), delta / root)
    return rho, w


def _blocks(n):
    for lo in range(0, n, ROWS_PER_BLOCK):
        yield lo, min(lo + ROWS_PER_BLOCK, n)


def chi2(x, obs, delta, dtype=torch.float64):
    """Robust chi2 of estimates ``x`` (a 0-d tensor of ``dtype``)."""
    cams, pts = (v.to(dtype) for v in x)
    total = torch.zeros((), dtype=dtype, device=cams.device)
    for lo, hi in _blocks(len(obs.cam)):
        e = (project(cams[obs.cam[lo:hi]], pts[obs.pt[lo:hi]])
             - obs.uv[lo:hi].to(dtype))
        total = total + torch.sum(huber(torch.sum(e * e, dim=-1), delta)[0])
    return total


class Linearization(NamedTuple):
    chi2: torch.Tensor     # robust chi2, 0-d
    bc: torch.Tensor       # (C, 9) camera rows of b = -J^T W e
    bp: torch.Tensor       # (P, 3) point rows of b
    Hc: torch.Tensor       # (C, 9, 9) camera diagonal blocks of J^T W J
    Hp: torch.Tensor       # (P, 3, 3) point diagonal blocks
    B: torch.Tensor        # (O, 9, 3) per observation J_c^T W J_p
    ac: torch.Tensor       # (C, 9) |J_c|^T W |e|: the size of b's terms
    ap: torch.Tensor       # (P, 3) |J_p|^T W |e|


def linearize(x, obs, delta, ar=None):
    """The robust Gauss-Newton system at ``x``; the Jacobians come from
    autograd through :func:`project`, a block of rows at a time."""
    ar = ar or Arith()
    dt = ar.dtype
    cams, pts = (v.to(dt) for v in x)
    C, P, O = cams.shape[0], pts.shape[0], len(obs.cam)
    dev = cams.device
    bc = torch.zeros((C, 9), dtype=dt, device=dev)
    bp = torch.zeros((P, 3), dtype=dt, device=dev)
    Hc = torch.zeros((C, 9, 9), dtype=dt, device=dev)
    Hp = torch.zeros((P, 3, 3), dtype=dt, device=dev)
    B = torch.empty((O, 9, 3), dtype=dt, device=dev)
    ac, ap = torch.zeros_like(bc), torch.zeros_like(bp)
    total = torch.zeros((), dtype=dt, device=dev)
    for lo, hi in _blocks(O):
        ci, pi = obs.cam[lo:hi], obs.pt[lo:hi]
        with torch.enable_grad():
            c = cams[ci].detach().requires_grad_(True)
            X = pts[pi].detach().requires_grad_(True)
            e = project(c, X) - obs.uv[lo:hi].to(dt)
            rows = [torch.autograd.grad(e[:, r].sum(), (c, X),
                                        retain_graph=(r == 0))
                    for r in range(2)]
        e = e.detach()
        Jc = torch.stack([rows[0][0], rows[1][0]], dim=1)     # (n, 2, 9)
        Jp = torch.stack([rows[0][1], rows[1][1]], dim=1)     # (n, 2, 3)
        rho, w = huber(torch.sum(e * e, dim=-1), delta)
        total = total + torch.sum(rho)
        bc.index_add_(0, ci, -ar.ein("e,eri,er->ei", w, Jc, e))
        bp.index_add_(0, pi, -ar.ein("e,eri,er->ei", w, Jp, e))
        Hc.index_add_(0, ci, ar.ein("e,eri,erj->eij", w, Jc, Jc))
        Hp.index_add_(0, pi, ar.ein("e,eri,erj->eij", w, Jp, Jp))
        B[lo:hi] = ar.ein("e,eri,erj->eij", w, Jc, Jp)
        ac.index_add_(0, ci, torch.einsum("e,eri,er->ei", w, Jc.abs(),
                                          e.abs()))
        ap.index_add_(0, pi, torch.einsum("e,eri,er->ei", w, Jp.abs(),
                                          e.abs()))
    return Linearization(total, bc, bp, Hc, Hp, B, ac, ap)


def max_diag(lin):
    """max |H_jj| over every camera and point tangent slot."""
    return torch.maximum(
        torch.diagonal(lin.Hc, dim1=-2, dim2=-1).abs().max(),
        torch.diagonal(lin.Hp, dim1=-2, dim2=-1).abs().max())
