"""The judgement of a job's output against the plain reference.

A job is a Levenberg-Marquardt run from a start ``x0``.  Its record holds
what the run under test produced, trial by trial: the estimate ``x`` whose
linearization the trial solved, the damping ``lam`` it used, its step
``dx`` and its CG iteration count; then the estimate, the chi2 and the
damping it returned.  The reference works out every trial again from the
run's own states, in float64, and reads:

* the step.  ``step_gap`` (``pcg``): the trial's step against the
  reference's PCG step at the same estimate, damping and CG count;
  ``cg_stop``: whether the trial's CG count meets the configured stop
  test, read as the residual norm of the reference's PCG after as many
  iterations over the threshold ``max(tol ||rhs||, sqrt(floor))``, the
  floor being half the job's previous solve's final squared residual, as
  the solver carries it (the larger of the reference's and that of the
  previous step the run made); at most about 1 where the count is the one
  the test asks for; a solve that reached ``max_iter``, or whose step is
  not finite, is not read.
  ``backward_error`` (``direct``): the componentwise backward error of the
  step in the whole damped system (the function below), which does not
  grow as the damping falls;
* ``path_gap``: the estimate the first trial linearized against the job's
  start, and the estimate each trial left (the next trial's ``x``, or the
  returned answer) against ``x + dx`` where the reference accepts the
  trial's candidate, ``x`` where it rejects it, parameter by parameter
  relative to the estimate (float32 rounding of the sum reads at most
  2^-24); a decision that turns on a chi2 change within ``CHI2_BAND`` of
  chi2 (float32 sums cannot resolve it) may go either way;
* ``lambda_gap``: the first damping against ``TAU max|H_jj|``, and every
  later one (the returned damping too) against the LM rule applied to the
  trial before: ``lam * max(1/3, 1 - (2 rho - 1)^3)`` after an accepted
  trial, with ``rho`` anywhere in the interval that chi2 values within
  ``CHI2_BAND`` and a scale within ``SCALE_BAND`` allow, ``lam * nu`` after
  a rejected one; the relative distance from that interval;
* ``iterations_gap``: 0 where the job ran the traffic's LM iterations, or
  stopped after an iteration that spent ``MAX_TRIALS`` trials; else the
  count of iterations it is off by;
* ``chi2_gap``: the returned chi2 against the reference's chi2 of the
  returned estimate.

A step that is not finite is the solver's report that the damped system
is singular at its precision: it is a gap of its own (infinite) unless the
damping lies below ``FLOAT32_EPS`` of the largest diagonal entry of H,
where a float32 system is singular to rounding; either way the trial must
be rejected, which ``path_gap`` checks.

The step gap is relative in the norm ||v||_H = sqrt(v^T H v)
of the trial's undamped Gauss-Newton matrix: the change a step makes to
the weighted residuals.  A free-gauge problem's H has a null space (a
similarity of the whole scene), along which a step is determined by the
damping alone and float32 rounding is amplified without bound; it moves no
residual, and this norm leaves it out.  Each number is the worst over the
job's trials.  Imports torch alone.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.bal import Arith, chi2, linearize, max_diag
from portbench.reference.schur import Reduced, pcg

CHI2_BAND = 1e-5
SCALE_BAND = 1e-3
FLOAT32_EPS = 2.0 ** -23
TAU = 1e-5               # g2o's OptimizationAlgorithmLevenberg defaults
MAX_TRIALS = 10
F64 = torch.float64


class JobRecord:
    """What one job produced (natural order: cameras, points)."""

    def __init__(self, x0):
        self.x0 = x0
        self.trials = []          # (x, lam, (dxc, dxp), cg iterations)
        self.final = None
        self.chi2 = None
        self.lam = None

    def trial(self, x, lam, dx, n_cg):
        self.trials.append((x, float(lam), dx, int(n_cg)))

    def finish(self, x, chi2, lam):
        self.final, self.chi2, self.lam = x, float(chi2), float(lam)


def _worst(gaps):
    """The largest of ``gaps``; a gap that is not a number counts as
    infinite."""
    return max(g if g == g else math.inf for g in gaps)


def _hnorm(lin, obs, v):
    """||v||_H for a step ``v = (cameras, points)``."""
    vc, vp = (t.to(F64) for t in v)
    q = (torch.einsum("ci,cij,cj->", vc, lin.Hc, vc)
         + torch.einsum("pi,pij,pj->", vp, lin.Hp, vp)
         + 2.0 * torch.einsum("ei,eij,ej->", vc[obs.cam], lin.B, vp[obs.pt]))
    return math.sqrt(max(float(q), 0.0))


def _rel(lin, obs, a, b):
    """||a - b||_H / ||b||_H."""
    return _worst([_hnorm(lin, obs, tuple(u.to(F64) - w.to(F64)
                                          for u, w in zip(a, b)))
                   / _hnorm(lin, obs, b)])


def backward_error(lin, lam, obs, dx):
    """The componentwise backward error of ``dx`` in (H + lam I) dx = b:
    the least relative change to the entries of H + lam I and to each
    observation's term of b that makes ``dx`` exact,
    max_i |r_i| / ((|H + lam I| |dx|)_i + (|J|^T W |e|)_i)."""
    vc, vp = (t.to(F64) for t in dx)
    eye = lambda n: lam * torch.eye(n, dtype=F64,       # noqa: E731
                                    device=vc.device)
    Hc, Hp = lin.Hc + eye(9), lin.Hp + eye(3)
    rc = (torch.einsum("cij,cj->ci", Hc, vc) - lin.bc).index_add_(
        0, obs.cam, torch.einsum("eij,ej->ei", lin.B, vp[obs.pt]))
    rp = (torch.einsum("pij,pj->pi", Hp, vp) - lin.bp).index_add_(
        0, obs.pt, torch.einsum("eij,ei->ej", lin.B, vc[obs.cam]))
    B, ac, ap = lin.B.abs(), vc.abs(), vp.abs()
    sc = (torch.einsum("cij,cj->ci", Hc.abs(), ac) + lin.ac).index_add_(
        0, obs.cam, torch.einsum("eij,ej->ei", B, ap[obs.pt]))
    sp = (torch.einsum("pij,pj->pi", Hp.abs(), ap) + lin.ap).index_add_(
        0, obs.pt, torch.einsum("eij,ei->ej", B, ac[obs.cam]))
    return _worst([max(float(torch.max(rc.abs() / sc)),
                       float(torch.max(rp.abs() / sp)))])


def _componentwise(a, b):
    """max_i |a_i - b_i| / |a_i| over every parameter: float32 storage of
    ``b`` reads at most 2^-24."""
    return _worst([float(torch.max((u.to(F64) - w.to(F64)).abs()
                                   / u.to(F64).abs().clamp_min(1e-300)))
                   for u, w in zip(a, b)])


def _same(a, b):
    return all(u is v or torch.equal(u, v) for u, v in zip(a, b))


def _lm_factor(rho):
    return max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)


def _outside(lam, lo, hi):
    """The relative distance of ``lam`` from [lo, hi]."""
    if lam > hi:
        return (lam - hi) / hi
    if lam < lo:
        return (lo - lam) / lo
    return 0.0 if lam == lam else math.inf


def judge(rec, obs, delta, solver, lm_iterations):
    """The numbers above of one job record (a dict), and under ``trials``
    each trial's (damping, CG count, step number or None, path gap,
    lambda gap, whether the step is finite, the reference's decision, chi2
    before and after it)."""
    ar = Arith(F64)
    pcg_kind = solver["kind"] == "pcg"
    out = {"path_gap": [0.0], "lambda_gap": []}
    if pcg_kind:
        out.update(step_gap=[0.0], cg_stop=[0.0])
    else:
        out["backward_error"] = [0.0]
    if not rec.trials:
        return {k: math.inf for k in out} | {
            "iterations_gap": math.inf, "chi2_gap": math.inf, "trials": []}
    detail, accepted, since_accept = [], 0, 0
    lin, lin_x, floor = None, None, None
    lo = hi = nu = None
    for k, (x, lam, dx, n_cg) in enumerate(rec.trials):
        if lin_x is None or not _same(x, lin_x):
            lin, lin_x = linearize(x, obs, delta), x
        if k == 0:
            lo = hi = TAU * float(max_diag(lin))
            nu = 2.0
        out["lambda_gap"].append(_outside(lam, lo, hi))
        x64 = tuple(v.to(F64) for v in x)
        finite = all(bool(torch.isfinite(d).all()) for d in dx)
        judged = finite or lam >= FLOAT32_EPS * float(max_diag(lin))
        sg = None
        if pcg_kind:
            red = Reduced(lin, lam, obs, ar)
            dxc, _, res2 = pcg(red, n=n_cg)
            if judged:
                sg = _rel(lin, obs, dx, (dxc, red.points(dxc)))
                out["step_gap"].append(sg)
            if finite and n_cg < solver["max_iter"]:
                thresh = solver["tol"] ** 2 * float(torch.sum(red.rhs
                                                              * red.rhs))
                if floor is not None:
                    thresh = max(thresh, floor)
                out["cg_stop"].append(math.sqrt(float(res2) / thresh))
            # the floor the solver carries is half its own final residual,
            # which float32 leaves above the reference's where CG runs deep
            floor = 0.5 * float(res2)
            if finite:
                r = red.apply(dx[0].to(F64)) - red.rhs
                floor = max(floor, 0.5 * float(torch.sum(r * r)))
        elif judged:
            sg = backward_error(lin, lam, obs, dx)
            out["backward_error"].append(sg)
        if k == 0:
            out["path_gap"].append(_componentwise(x, rec.x0))
        # the reference's decision on the candidate this trial made
        cand = tuple(a + d.to(F64) for a, d in zip(x64, dx))
        chi0 = float(lin.chi2)
        chi = float(chi2(cand, obs, delta))
        scale = float(sum(torch.sum(d.to(F64) * (lam * d.to(F64) + bb))
                          for d, bb in zip(dx, (lin.bc, lin.bp)))) + 1e-3
        accept = (math.isfinite(chi) and chi < chi0
                  and (chi0 - chi) / scale > 0)
        nxt = (rec.trials[k + 1][0] if k + 1 < len(rec.trials)
               else rec.final)
        stayed = _same(nxt, x)
        if not finite:
            path = 0.0 if stayed else math.inf
        else:
            gap_accept = _componentwise(nxt, cand)
            gap_reject = _componentwise(nxt, x64)
            if abs(chi0 - chi) <= CHI2_BAND * abs(chi0):
                path = min(gap_accept, gap_reject)
            else:
                path = gap_accept if accept else gap_reject
        out["path_gap"].append(path)
        detail.append((lam, n_cg, sg, path, out["lambda_gap"][-1], finite,
                       accept, chi0, chi))
        # the damping the LM rule allows for the next trial
        if not stayed:
            band = 2.0 * CHI2_BAND * abs(chi0)
            rho_hi = (chi0 - chi + band) / (scale * (1.0 - SCALE_BAND))
            rho_lo = max((chi0 - chi - band) / (scale * (1.0 + SCALE_BAND)),
                         0.0)
            if math.isfinite(rho_hi):
                lo, hi = lam * _lm_factor(rho_hi), lam * _lm_factor(rho_lo)
            else:                    # no chi2 here: any accepted factor
                lo, hi = lam / 3.0, 2.0 * lam
            nu, since_accept = 2.0, 0
            accepted += 1
        else:
            lo = hi = lam * nu
            nu *= 2.0
            since_accept += 1
    out["lambda_gap"].append(_outside(rec.lam, lo, hi))
    ran_out = since_accept == MAX_TRIALS and accepted < lm_iterations
    done = accepted == lm_iterations and since_accept == 0
    gaps = {k: _worst(v) for k, v in out.items()}
    gaps["iterations_gap"] = (0.0 if ran_out or done
                              else float(max(1, abs(lm_iterations
                                                    - accepted))))
    ref_chi = float(chi2(rec.final, obs, delta))
    gaps["chi2_gap"] = _worst([abs(rec.chi2 - ref_chi) / ref_chi])
    gaps["trials"] = detail
    return gaps
