"""Plain Schur-complement steps and Levenberg-Marquardt for BAL.

The damped system (H + lam I) dx = b splits into cameras and points.
With D_l = Hp_l + lam I per point and B_e the camera-point block of
observation e, the points are eliminated:

    S = Hc + lam I - sum_{e, f share a point l} B_e D_l^-1 B_f^T
    S dxc = bc - sum_e B_e (D^-1 bp)_l(e)
    dxp_l = D_l^-1 (bp_l - sum_{e of l} B_e^T dxc_c(e))

``pcg`` solves the camera system matrix-free by preconditioned conjugate
gradients (x0 = 0, the block preconditioner the camera diagonal blocks of
S, as the port's ``schur_jacobi``), for ``n`` iterations or until
||r||^2 <= max(tol^2 ||b||^2, floor); ``direct`` forms S densely and
factors it by Cholesky (a NaN step where S is not positive definite).
``levenberg_marquardt`` is the LM of g2o's
``OptimizationAlgorithmLevenberg``: lam0 = tau max|H_jj|, gain ratio
rho = (chi0 - chi) / (dx^T (lam dx + b) + 1e-3), accept with
lam *= max(1/3, 1 - (2 rho - 1)^3), else lam *= nu, nu *= 2, at most
``max_trials`` trials an iteration.  Imports torch alone.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.bal import linearize, max_diag

PAIRS_PER_BLOCK = 1 << 21


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


class Reduced:
    """The camera system of one damped linearization, applied by blocks."""

    def __init__(self, lin, lam, obs, ar):
        self.lin, self.lam, self.obs, self.ar = lin, lam, obs, ar
        self.Dinv = torch.linalg.inv(lin.Hp + lam * _eye(3, lin.Hp))
        self.Hc = lin.Hc + lam * _eye(9, lin.Hc)
        y = ar.ein("lij,lj->li", self.Dinv, lin.bp)
        self.rhs = lin.bc.index_add(
            0, obs.cam, ar.ein("eij,ej->ei", lin.B, y[obs.pt]), alpha=-1)
        M = self.Hc.clone()
        for lo in range(0, len(obs.cam), PAIRS_PER_BLOCK):
            hi = lo + PAIRS_PER_BLOCK
            Be = lin.B[lo:hi]
            M.index_add_(0, obs.cam[lo:hi], ar.ein(
                "eij,ejk,elk->eil", Be, self.Dinv[obs.pt[lo:hi]], Be),
                alpha=-1)
        self.Minv = torch.linalg.inv(M)

    def apply(self, v):
        """S v for camera vectors v (C, 9)."""
        ar, lin, obs = self.ar, self.lin, self.obs
        t = torch.zeros_like(lin.bp).index_add_(
            0, obs.pt, ar.ein("eij,ei->ej", lin.B, v[obs.cam]))
        s = ar.ein("lij,lj->li", self.Dinv, t)
        return ar.ein("cij,cj->ci", self.Hc, v).index_add_(
            0, obs.cam, ar.ein("eij,ej->ei", lin.B, s[obs.pt]), alpha=-1)

    def precondition(self, r):
        return self.ar.ein("cij,cj->ci", self.Minv, r)

    def points(self, dxc):
        """The eliminated point step for a camera step ``dxc``."""
        ar, lin, obs = self.ar, self.lin, self.obs
        w = torch.zeros_like(lin.bp).index_add_(
            0, obs.pt, ar.ein("eij,ei->ej", lin.B, dxc[obs.cam]))
        return ar.ein("lij,lj->li", self.Dinv, lin.bp - w)


def pcg(red, n=None, tol=0.0, floor=None, max_iter=100):
    """``(dxc, iterations, final ||r||^2)``; exactly ``n`` iterations when
    ``n`` is given, else the stop test above."""
    b = red.rhs
    x = torch.zeros_like(b)
    r = b.clone()
    z = red.precondition(r)
    p, rz = z, torch.sum(r * z)
    thresh = tol * tol * torch.sum(b * b)
    if floor is not None:
        thresh = torch.maximum(thresh, floor)
    it = 0
    while (it < n) if n is not None else (
            it < max_iter and bool(torch.sum(r * r) > thresh)):
        Ap = red.apply(p)
        alpha = rz / torch.sum(p * Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = red.precondition(r)
        rz2 = torch.sum(r * z)
        p = z + (rz2 / rz) * p
        rz = rz2
        it += 1
    return x, it, torch.sum(r * r)


def dense_camera_system(red):
    """S as a dense (9C, 9C) matrix: every ordered pair of observations of
    one point, a block of pairs at a time."""
    lin, obs, ar = red.lin, red.obs, red.ar
    C = lin.Hc.shape[0]
    S = torch.zeros((C * C, 81), dtype=lin.Hc.dtype, device=lin.Hc.device)
    diag = torch.arange(C, device=S.device) * (C + 1)
    S.index_add_(0, diag, red.Hc.reshape(C, 81))
    BD = ar.ein("eij,ejk->eik", lin.B, red.Dinv[obs.pt])        # (O, 9, 3)
    order = torch.argsort(obs.pt, stable=True)
    count = torch.bincount(obs.pt, minlength=lin.Hp.shape[0])
    start = torch.cumsum(count, 0) - count
    for k in torch.unique(count).tolist():
        if k == 0:
            continue
        pts = torch.nonzero(count == k).flatten()
        per = max(1, PAIRS_PER_BLOCK // (k * k))
        for lo in range(0, len(pts), per):
            rows = order[start[pts[lo:lo + per], None]
                         + torch.arange(k, device=S.device)]      # (n, k)
            a = rows[:, :, None].expand(-1, k, k).reshape(-1)
            bb = rows[:, None, :].expand(-1, k, k).reshape(-1)
            M = ar.ein("pij,pkj->pik", BD[a], lin.B[bb])
            S.index_add_(0, obs.cam[a] * C + obs.cam[bb],
                         M.reshape(-1, 81), alpha=-1)
    return S.reshape(C, C, 9, 9).permute(0, 2, 1, 3).reshape(9 * C, 9 * C)


def cholesky(S, ar, block=128):
    """``(L, info)``: the Cholesky factor of S; with TF32 operands, a
    right-looking blocked factorization whose trailing updates take TF32
    operands, as a factorization built on TF32 matrix products does."""
    if not ar.tf32:
        return torch.linalg.cholesky_ex(S)
    n = S.shape[0]
    A, L = S.clone(), torch.zeros_like(S)
    for j in range(0, n, block):
        e = min(j + block, n)
        L11, info = torch.linalg.cholesky_ex(A[j:e, j:e])
        if int(info):
            return L, info
        L[j:e, j:e] = L11
        if e < n:
            L21 = torch.linalg.solve_triangular(
                L11, A[e:, j:e].T, upper=False).T
            L[e:, j:e] = L21
            A[e:, e:] -= ar.ein("ik,jk->ij", L21, L21)
    return L, info


def direct(red):
    """The camera step by a dense Cholesky factorization of S."""
    S = dense_camera_system(red)
    L, info = cholesky(S, red.ar)
    x = torch.cholesky_solve(red.rhs.reshape(-1, 1), L).reshape(-1, 9)
    return torch.where(info == 0, x, torch.full_like(x, math.nan))


def step(lin, lam, obs, ar, solver, n=None, floor=None):
    """``(dxc, dxp, cg iterations, final ||r||^2)`` of one damped solve;
    ``solver`` is the configuration's ``reference_solver``."""
    red = Reduced(lin, lam, obs, ar)
    if solver["kind"] == "pcg":
        dxc, it, res2 = pcg(red, n=n, tol=solver["tol"], floor=floor,
                            max_iter=solver["max_iter"])
    else:
        dxc, it, res2 = direct(red), 0, None
    return dxc, red.points(dxc), it, res2


def levenberg_marquardt(x, obs, delta, solver, iterations, ar, record,
                        tau=1e-5, max_trials=10):
    """Run LM from ``x`` in the arithmetic ``ar``; ``record`` (a
    ``portbench.reference.check.JobRecord``) receives every trial and the
    result."""
    lin = linearize(x, obs, delta, ar)
    lam = tau * float(max_diag(lin))
    nu = 2.0
    floor = None                 # the residual floor carried across solves
    for _ in range(iterations):
        chi0 = float(lin.chi2)
        good, trials = False, 0
        while not good and trials < max_trials:
            dxc, dxp, it, res2 = step(lin, lam, obs, ar, solver, floor=floor)
            if res2 is not None:
                floor = 0.5 * res2
            record.trial(x, lam, (dxc, dxp), it)
            cand = (x[0] + dxc, x[1] + dxp)
            lin_c = linearize(cand, obs, delta, ar)
            chi = float(lin_c.chi2)
            scale = float(torch.sum(dxc * (lam * dxc + lin.bc))
                          + torch.sum(dxp * (lam * dxp + lin.bp))) + 1e-3
            rho = (chi0 - chi) / scale
            good = math.isfinite(chi) and rho > 0 and chi < chi0
            trials += 1
            if good:
                lam *= max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
                nu = 2.0
                x, lin = cand, lin_c
            else:
                lam *= nu
                nu *= 2.0
        if not good:
            break
    record.finish(x, lin.chi2, lam)
    return x
