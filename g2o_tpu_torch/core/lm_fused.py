"""Whole-run Levenberg-Marquardt and Gauss-Newton with a carried
linearization — port of ``g2o_tpu/core/lm_fused.py``.

The JAX package runs the whole optimization as one device program
(``lax.while_loop``); here the loops are Python loops over device tensors,
reading one scalar per λ-trial to decide acceptance.  The semantics are the
reference LM's (``optimization_algorithm_levenberg.cpp:58-145``):

* ``λ₀ = τ·max|H_jj|`` from the first linearization, requested with a
  negative ``λ`` (the ``−τ`` sentinel);
* gain ratio ``ρ = (χ₀ − χ)/(dxᵀ(λ dx + b) + 1e-3)``;
* accept ``λ *= max(1/3, 1 − (2ρ−1)³), ν = 2``; reject ``λ *= ν, ν *= 2``;
* at most ``max_trials`` trials per iteration.

A trial's chi2 comes from LINEARIZING the candidate; the accepted
candidate's linearization is carried into the next iteration, so no
residual pass is repeated.  :func:`optimize_fused_gn` is the reference GN
(``optimization_algorithm_gauss_newton.cpp:50``) in the same style: a
solve at λ = 0 and the update, no trust region.
The chi2 histories are the linearization's chi2, read as Python floats:
at ``state_dtype`` for a mixed-precision problem.  On sharded data
(``g2o_tpu_torch.parallel``) every value read here — chi2, λ₀ from the
diagonal blocks, the gain ratio's ``dxᵀ(λ dx + b)`` — is replicated, so
every rank takes the same decisions.
:class:`FusedLevenbergMarquardt` is the same LM iteration as an algorithm
of :class:`~g2o_tpu_torch.core.optimizer.SparseOptimizer`.
"""

from __future__ import annotations

import itertools
import math
import time

import torch

from g2o_tpu_torch.core.optimizer import (OptimizationAlgorithm,
                                          _max_abs_diag)
from g2o_tpu_torch.utils.tictoc import span

# per-solver-object cache token: ``id(solver)`` is NOT a safe key — CPython
# reuses the id of a collected solver for the next allocation, so a cache
# keyed on it could hand one solver's closure to another
_SOLVER_TOKENS = itertools.count()


def _solver_token(solver):
    tok = solver.__dict__.get("_runner_token")
    if tok is None:
        tok = next(_SOLVER_TOKENS)
        solver.__dict__["_runner_token"] = tok
    return tok


def _cap_cache(cache, limit: int = 8):
    """Evict the oldest entries so a problem's runner cache stays bounded."""
    while len(cache) >= limit:
        cache.pop(next(iter(cache)))


def _solve(p, solver, lin, lam, sstate, data=None, aux=None):
    """One solve ``(dx, sstate', cg_iterations)``: through the STATEFUL
    protocol (``solver._solve_state_fn(data, lin, lam, state) -> (dx,
    state', stats)``, e.g. the PCG residual floor) when the solver has it,
    else ``solver._solve_fn(data, lin, lam, aux)`` with the state passed
    through and a CG count of 0.  ``data`` and ``aux`` default to the
    problem's and the solver's."""
    data = p.data if data is None else data
    solve_state_fn = getattr(solver, "_solve_state_fn", None)
    if solve_state_fn is None:
        return (solver._solve_fn(data, lin, lam,
                                 solver.aux if aux is None else aux),
                sstate, 0)
    dx, sstate, st = solve_state_fn(data, lin, lam, sstate)
    return dx, sstate, int(st.get("cg_iterations", 0))


def make_lm_iteration(problem, solver, max_trials: int):
    """The LM iteration ``(estimates, lam, ni, sstate, lin, data=None,
    aux=None) -> (estimates', chi0, chi_final, lam', ni', good, trials,
    sstate', cg_total, lin')``; :func:`_solve` threads the solver state
    ``sstate`` through every trial.  ``data`` and ``aux`` default to the
    problem's and the solver's."""
    p = problem

    def one_iteration(estimates, lam, ni, sstate, lin, data=None, aux=None):
        data = p.data if data is None else data
        with span("read.chi2"):
            chi0 = float(lin.chi2_robust)
        good, trials, cg = False, 0, 0
        est_out, chi_out, lin_out = estimates, chi0, lin
        while not good and trials < max_trials:
            with span("lm.trial"):
                dx, sstate, n_cg = _solve(p, solver, lin, lam, sstate, data,
                                          aux)
                cg += n_cg
                cand = p.apply_update_fn(data, estimates, dx)
                lin_cand = p.linearize_fn(data, cand)
                with span("read.chi2"):
                    chi_new = float(lin_cand.chi2_robust)
                with span("read.gain"):
                    scale = float(torch.sum(dx * (lam * dx + lin.b))) + 1e-3
                rho = (chi0 - chi_new) / scale
                good = math.isfinite(chi_new) and rho > 0 and chi_new < chi0
                trials += 1
                if good:
                    lam *= max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
                    ni = 2.0
                    est_out, chi_out, lin_out = cand, chi_new, lin_cand
                else:
                    lam *= ni
                    ni *= 2.0
        return (est_out, chi0, chi_out, lam, ni, good, trials, sstate, cg,
                lin_out)

    return one_iteration


def _padded(values, n, fill, dtype, device):
    """``values`` followed by ``fill`` up to ``n``: a history padded to the
    JAX package's static length."""
    out = torch.full((n,), fill, dtype=dtype, device=device)
    if values:
        out[:len(values)] = torch.tensor(values, dtype=dtype, device=device)
    return out


def make_lm_run(problem, solver, *, max_trials: int = 10,
                max_iters: int = 512, gain_threshold: float = 0.0):
    """The whole LM optimization as one function, as the JAX package's
    ``make_lm_run`` returns it: ``run(data, estimates, lam, ni, n_iters,
    aux, sstate) -> (estimates, lam, ni, iters_done, chi_hist, trial_hist,
    cg_hist, chi_final)``, a loop of at most ``min(n_iters, max_iters)``
    iterations of :func:`make_lm_iteration`.  ``lam < 0`` requests ``λ₀ =
    −lam·max|H_jj|`` of the first linearization.  It stops after an
    iteration that exhausts its trials or, with ``gain_threshold > 0``, one
    past the first whose relative chi2 gain falls below it.  The histories
    are padded to ``max_iters`` (chi2 NaN at ``state_dtype``, int32 counts
    0); ``chi_final`` is ``inf`` after no iteration.  ``solver`` must be
    set up for ``problem``; ``problem.estimates`` are left as they are."""
    one_iteration = make_lm_iteration(problem, solver, max_trials)
    p = problem
    gt = float(gain_threshold)

    def run(data, estimates, lam, ni, n_iters, aux, sstate):
        lam, ni = float(lam), float(ni)
        lin = p.linearize_fn(data, estimates)
        if lam < 0:
            with span("read.lambda0"):
                lam = -lam * float(_max_abs_diag(p, lin))
        est, chi_prev = estimates, math.inf
        chi_hist, trial_hist, cg_hist = [], [], []
        for it in range(min(int(n_iters), max_iters)):
            (est, chi0, chi_f, lam, ni, good, trials, sstate, cg,
             lin) = one_iteration(est, lam, ni, sstate, lin, data, aux)
            chi_hist.append(chi0)
            trial_hist.append(trials)
            cg_hist.append(cg)
            gain = (chi_prev - chi_f) / max(chi_prev, 1e-30)
            chi_prev = chi_f
            if not good or (gt > 0 and it > 0 and gain < gt):
                break
        dev = p.device
        return (est, lam, ni, len(chi_hist),
                _padded(chi_hist, max_iters, math.nan, p.state_dtype, dev),
                _padded(trial_hist, max_iters, 0, torch.int32, dev),
                _padded(cg_hist, max_iters, 0, torch.int32, dev), chi_prev)

    return run


def optimize_fused(problem, solver, max_iterations: int, *,
                   initial_lambda: float = 0.0, tau: float = 1e-5,
                   max_trials: int = 10, gain_threshold: float = 0.0,
                   history_cap: int = 512):
    """Run a whole LM optimization.  Mutates ``problem.estimates``; returns
    a dict with the per-iteration histories (the JAX package's keys).
    Stops early when an iteration exhausts its trials or, with
    ``gain_threshold > 0``, after an iteration past the first whose
    relative chi2 gain ``(χ_prev − χ)/χ_prev`` falls below it.
    ``max_iterations`` is clamped to ``history_cap``, the JAX package's
    static history length."""
    solver.setup(problem)
    max_iterations = min(int(max_iterations), int(history_cap))
    gt = float(gain_threshold)
    lam = initial_lambda if initial_lambda > 0 else -tau
    cache = problem.__dict__.setdefault("_lm_runner_cache", {})
    key = (_solver_token(solver), max_trials)
    one_iteration = cache.get(key)
    if one_iteration is None:
        one_iteration = make_lm_iteration(problem, solver, max_trials)
        _cap_cache(cache)
        cache[key] = one_iteration
    sstate = getattr(solver, "state0", None)
    cuda = problem.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(problem.device)
    t0 = time.perf_counter()
    est = problem.estimates
    lin = problem.linearize_fn(problem.data, est)
    if lam < 0:
        with span("read.lambda0"):
            lam = -lam * float(_max_abs_diag(problem, lin))
    ni = 2.0
    chi_hist, trial_hist, cg_hist = [], [], []
    with span("read.chi2"):
        chi_f = chi_prev = float(lin.chi2_robust)
    for it in range(max_iterations):
        (est, chi0, chi_f, lam, ni, good, trials, sstate, cg,
         lin) = one_iteration(est, lam, ni, sstate, lin)
        chi_hist.append(chi0)
        trial_hist.append(trials)
        cg_hist.append(cg)
        gain = (chi_prev - chi_f) / max(chi_prev, 1e-30)
        if not good or (gt > 0 and it > 0 and gain < gt):
            break
        chi_prev = chi_f
    if cuda:
        torch.cuda.synchronize(problem.device)
    wall = time.perf_counter() - t0
    problem.set_estimates(est)
    return {
        "iterations": len(chi_hist),
        "wall_s": wall,
        "chi2_per_iteration": chi_hist,
        "trials_per_iteration": trial_hist,
        "cg_per_iteration": cg_hist,
        "chi2_final": chi_f,
        "lambda_final": lam,
    }


def optimize_fused_gn(problem, solver, max_iterations: int, *,
                      history_cap: int = 512):
    """Run a whole Gauss-Newton optimization: linearize → solve at λ = 0 →
    oplus.  The chi2 of a step comes with the next linearization; a
    non-finite chi2 keeps the previous estimate and linearization and
    stops.  A stateful solver (the PCG residual floor) threads its state
    across iterations.  ``max_iterations`` is clamped to ``history_cap``.
    Mutates ``problem.estimates``; returns the JAX package's keys."""
    solver.setup(problem)
    max_iterations = min(int(max_iterations), int(history_cap))
    p = problem
    sstate = getattr(solver, "state0", None)
    cuda = p.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(p.device)
    t0 = time.perf_counter()
    est = p.estimates
    lin = p.linearize_fn(p.data, est)
    chi = float(lin.chi2_robust)
    chi_hist, cg_hist = [], []
    for _ in range(max_iterations):
        dx, sstate, n_cg = _solve(p, solver, lin, 0.0, sstate)
        cg_hist.append(n_cg)
        chi_hist.append(chi)
        new = p.apply_update_fn(p.data, est, dx)
        lin_new = p.linearize_fn(p.data, new)
        chi_new = float(lin_new.chi2_robust)
        if not math.isfinite(chi_new):
            break
        est, lin, chi = new, lin_new, chi_new
    if cuda:
        torch.cuda.synchronize(p.device)
    wall = time.perf_counter() - t0
    p.set_estimates(est)
    return {
        "iterations": len(chi_hist),
        "wall_s": wall,
        "chi2_per_iteration": chi_hist,
        "cg_per_iteration": cg_hist,
        "chi2_final": chi,
    }


def make_gn_run(problem, solver, *, max_iters: int = 512):
    """The whole Gauss-Newton optimization as one function, as the JAX
    package's ``make_gn_run`` returns it: ``run(data, estimates, n_iters,
    aux, sstate) -> (estimates, iters_done, chi_hist, cg_hist,
    chi_final)``, at most ``min(n_iters, max_iters)`` iterations of
    linearize → solve at λ = 0 → oplus (reference
    ``optimization_algorithm_gauss_newton.cpp:50``).  A step whose chi2 is
    not finite is dropped and ends the run; a stateful solver threads its
    state across iterations.  The histories are padded to ``max_iters``
    (chi2 NaN at ``state_dtype``, int32 CG counts 0).  ``solver`` must be
    set up for ``problem``; ``problem.estimates`` are left as they are."""
    p = problem

    def run(data, estimates, n_iters, aux, sstate):
        est = estimates
        lin = p.linearize_fn(data, est)
        chi = float(lin.chi2_robust)
        chi_hist, cg_hist = [], []
        for _ in range(min(int(n_iters), max_iters)):
            dx, sstate, n_cg = _solve(p, solver, lin, 0.0, sstate, data, aux)
            cg_hist.append(n_cg)
            chi_hist.append(chi)
            new = p.apply_update_fn(data, est, dx)
            lin_new = p.linearize_fn(data, new)
            chi_new = float(lin_new.chi2_robust)
            if not math.isfinite(chi_new):
                break
            est, lin, chi = new, lin_new, chi_new
        dev = p.device
        return (est, len(chi_hist),
                _padded(chi_hist, max_iters, math.nan, p.state_dtype, dev),
                _padded(cg_hist, max_iters, 0, torch.int32, dev), chi)

    return run


class FusedLevenbergMarquardt(OptimizationAlgorithm):
    """LM as a :class:`~g2o_tpu_torch.core.optimizer.SparseOptimizer`
    algorithm over :func:`make_lm_iteration`: the linearization of the
    accepted candidate is carried into the next iteration, and the solver
    state (the PCG residual floor) across iterations."""

    def __init__(self, initial_lambda: float = 0.0,
                 max_trials_after_failure: int = 10, tau: float = 1e-5):
        self.initial_lambda = float(initial_lambda)
        self.max_trials = int(max_trials_after_failure)
        self.tau = tau
        self._lambda = None
        self._ni = None
        self._iteration = None
        self._levenberg_iters = 0

    def init(self, optimizer):
        self._lambda = None
        self._ni = 2.0
        # one iteration closure per (problem, solver, trials): init() runs
        # at the top of every optimize() call
        key = (_solver_token(optimizer.solver), self.max_trials)
        cache = optimizer.problem.__dict__.setdefault("_lm_step_cache", {})
        one_iteration = cache.get(key)
        if one_iteration is None:
            one_iteration = make_lm_iteration(optimizer.problem,
                                              optimizer.solver,
                                              self.max_trials)
            _cap_cache(cache)
            cache[key] = one_iteration
        self._iteration = one_iteration
        self._lin = None       # carried linearization
        self._sstate = getattr(optimizer.solver, "state0", None)

    def step(self, optimizer, iteration, stats):
        p = optimizer.problem
        if self._lin is None:
            self._lin = p.linearize_fn(p.data, p.estimates)
        if self._lambda is None:
            if self.initial_lambda > 0:
                self._lambda = self.initial_lambda
            else:
                # as optimize_fused derives λ₀ from its first linearization
                self._lambda = self.tau * float(_max_abs_diag(p, self._lin))
        (est, chi0, chi_f, lam, ni, good, trials, self._sstate, cg_total,
         self._lin) = self._iteration(p.estimates, self._lambda, self._ni,
                                      self._sstate, self._lin)
        stats.chi2 = chi0
        self._lambda, self._ni = lam, ni
        stats.lambda_value = lam
        stats.levenberg_iterations = trials
        stats.iterations_linear_solver = cg_total
        self._levenberg_iters = trials
        if not good:
            # a retried step relinearizes the (unchanged) estimates
            self._lin = None
            return False
        p.set_estimates(est)
        optimizer.current_chi2 = chi_f
        return True

    def print_verbose_suffix(self):
        return (f"\t lambda= {self._lambda:.6g}"
                f"\t levenbergIter= {self._levenberg_iters}")
