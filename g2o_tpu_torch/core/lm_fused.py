"""Whole-run Levenberg-Marquardt with a carried linearization — port of
``g2o_tpu/core/lm_fused.py``.

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
residual pass is repeated.
"""

from __future__ import annotations

import itertools
import math
import time

import torch

from g2o_tpu_torch.core.optimizer import _max_abs_diag

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


def make_lm_iteration(problem, solver, max_trials: int):
    """The LM iteration ``(estimates, lam, ni, sstate, lin) -> (estimates',
    chi0, chi_final, lam', ni', good, trials, sstate', cg_total, lin')``.
    ``sstate`` is the solver's carried state (the PCG residual floor)."""
    p = problem

    def one_iteration(estimates, lam, ni, sstate, lin):
        chi0 = float(lin.chi2_robust)
        good, trials, cg = False, 0, 0
        est_out, chi_out, lin_out = estimates, chi0, lin
        while not good and trials < max_trials:
            dx, sstate, st = solver._solve_state_fn(p.data, lin, lam, sstate)
            cg += int(st.get("cg_iterations", 0))
            cand = p.apply_update_fn(p.data, estimates, dx)
            lin_cand = p.linearize_fn(p.data, cand)
            chi_new = float(lin_cand.chi2_robust)
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


def optimize_fused(problem, solver, max_iterations: int, *,
                   initial_lambda: float = 0.0, tau: float = 1e-5,
                   max_trials: int = 10):
    """Run a whole LM optimization.  Mutates ``problem.estimates``; returns
    a dict with the per-iteration histories (the JAX package's keys).
    Stops early when an iteration exhausts its trials."""
    solver.setup(problem)
    lam = initial_lambda if initial_lambda > 0 else -tau
    cache = problem.__dict__.setdefault("_lm_runner_cache", {})
    key = (_solver_token(solver), max_trials)
    one_iteration = cache.get(key)
    if one_iteration is None:
        one_iteration = make_lm_iteration(problem, solver, max_trials)
        _cap_cache(cache)
        cache[key] = one_iteration
    sstate = solver.state0
    cuda = problem.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(problem.device)
    t0 = time.perf_counter()
    est = problem.estimates
    lin = problem.linearize_fn(problem.data, est)
    if lam < 0:
        lam = -lam * float(_max_abs_diag(problem, lin))
    ni = 2.0
    chi_hist, trial_hist, cg_hist = [], [], []
    chi_f = float(lin.chi2_robust)
    for _ in range(max_iterations):
        (est, chi0, chi_f, lam, ni, good, trials, sstate, cg,
         lin) = one_iteration(est, lam, ni, sstate, lin)
        chi_hist.append(chi0)
        trial_hist.append(trials)
        cg_hist.append(cg)
        if not good:
            break
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
