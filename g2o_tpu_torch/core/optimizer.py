"""The optimizer front end and the host-loop Levenberg-Marquardt — port of
``g2o_tpu/core/optimizer.py`` (GN and Dogleg are not ported yet).

:class:`LevenbergMarquardt` keeps the reference trust-region bookkeeping
(``g2o/core/optimization_algorithm_levenberg.cpp:58``): ``λ₀ = τ·max|H_jj|``
(``:152``), gain ratio ``ρ = (χ₀ − χ)/(dxᵀ(λ dx + b) + 1e-3)``
(``:124-127``), accept ``λ *= max(1/3, 1 − (2ρ−1)³), ν = 2``, reject
``λ *= ν, ν *= 2`` (``:128-142``), and the inner-trial cap (``:49``).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import torch


@dataclasses.dataclass
class BatchStatistics:
    """Per-iteration stats — schema of ``G2OBatchStatistics``
    (``g2o/core/batch_stats.h:40-77``)."""

    iteration: int = -1
    num_vertices: int = 0
    num_edges: int = 0
    chi2: float = 0.0
    time_residuals: float = 0.0
    time_linearize: float = 0.0
    time_quadratic_form: float = 0.0
    time_schur_complement: float = 0.0
    time_linear_solver: float = 0.0
    time_update: float = 0.0
    time_iteration: float = 0.0
    levenberg_iterations: int = 0
    lambda_value: float = 0.0
    iterations_linear_solver: int = 0

    def as_dict(self):
        return dataclasses.asdict(self)


def _max_abs_diag(problem, lin):
    """max |H_jj| over non-fixed vertices (LM λ init,
    ``optimization_algorithm_levenberg.cpp:152-176``), a 0-d tensor."""
    m = torch.tensor(-math.inf, dtype=problem.dtype, device=problem.device)
    for t in problem.vertex_types:
        de = torch.diagonal(lin.diag[t], dim1=-2, dim2=-1).abs()
        mask = 1.0 - problem.data.fixed[t].to(problem.dtype)
        if de.numel():
            m = torch.maximum(m, torch.max(de * mask[:, None]))
    return m


class OptimizationAlgorithm:
    """Strategy interface (reference ``OptimizationAlgorithm``)."""

    def init(self, optimizer):
        pass

    def step(self, optimizer, iteration: int, stats: BatchStatistics) -> bool:
        raise NotImplementedError

    def print_verbose_suffix(self) -> str:
        return ""


class LevenbergMarquardt(OptimizationAlgorithm):
    def __init__(self, initial_lambda: float = 0.0,
                 max_trials_after_failure: int = 10, tau: float = 1e-5):
        self.initial_lambda = initial_lambda
        self.max_trials = int(max_trials_after_failure)
        self.tau = tau
        self._lambda = None
        self._ni = 2.0
        self._levenberg_iters = 0

    def init(self, optimizer):
        self._lambda = None
        self._ni = 2.0

    def step(self, optimizer, iteration, stats):
        p = optimizer.problem
        t0 = time.perf_counter()
        lin = p.linearize_fn(p.data, p.estimates)
        current_chi2 = float(lin.chi2_robust)
        stats.chi2 = current_chi2
        stats.time_linearize = time.perf_counter() - t0

        if self._lambda is None:
            if self.initial_lambda > 0:
                self._lambda = float(self.initial_lambda)
            else:
                self._lambda = float(self.tau * _max_abs_diag(p, lin))

        trials = 0
        good = False
        t_solve = 0.0
        while not good and trials < self.max_trials:
            t0 = time.perf_counter()
            dx = optimizer.solver.solve(p.data, lin, self._lambda)
            new_est = p.apply_update_fn(p.data, p.estimates, dx)
            chi2_new = float(p.chi2_fn(p.data, new_est)[0])
            t_solve += time.perf_counter() - t0
            scale = float(torch.sum(dx * (self._lambda * dx + lin.b))) + 1e-3
            rho = (current_chi2 - chi2_new) / scale
            if math.isfinite(chi2_new) and rho > 0 and chi2_new < current_chi2:
                good = True
                self._lambda *= max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
                self._ni = 2.0
                p.set_estimates(new_est)
                optimizer.current_chi2 = chi2_new
            else:
                self._lambda *= self._ni
                self._ni *= 2.0
                trials += 1
                if not math.isfinite(self._lambda):
                    break
        stats.time_linear_solver = t_solve
        stats.levenberg_iterations = trials + (1 if good else 0)
        stats.lambda_value = self._lambda
        self._levenberg_iters = stats.levenberg_iterations
        return good

    def print_verbose_suffix(self):
        return (f"\t lambda= {self._lambda:.6g}"
                f"\t levenbergIter= {self._levenberg_iters}")


class SparseOptimizer:
    """The optimizer front end — reference ``SparseOptimizer``
    (``g2o/core/sparse_optimizer.h:44``)."""

    def __init__(self, problem, algorithm: Optional[OptimizationAlgorithm] = None,
                 solver=None, verbose: bool = False):
        from g2o_tpu_torch.core.solvers.pcg import PCGSolver

        self.problem = problem
        self.algorithm = algorithm or LevenbergMarquardt()
        # the JAX package defaults to its dense solver, which is not ported
        self.solver = (solver or PCGSolver()).setup(problem)
        self.verbose = verbose
        self.current_chi2 = None
        self.batch_statistics: list[BatchStatistics] = []

    def chi2(self):
        return float(self.problem.chi2_fn(self.problem.data,
                                          self.problem.estimates)[0])

    def optimize(self, max_iterations: int) -> int:
        self.algorithm.init(self)
        self.batch_statistics = []
        cum_time = 0.0
        it = 0
        for it in range(max_iterations):
            stats = BatchStatistics(
                iteration=it,
                num_vertices=sum(self.problem.counts.values()),
                num_edges=self.problem.num_edges)
            t0 = time.perf_counter()
            ok = self.algorithm.step(self, it, stats)
            stats.time_iteration = time.perf_counter() - t0
            cum_time += stats.time_iteration
            self.batch_statistics.append(stats)
            if self.verbose:
                print(f"iteration= {it}\t chi2= {stats.chi2:.6f}\t "
                      f"time= {stats.time_iteration:.5g}\t "
                      f"cumTime= {cum_time:.5g}\t "
                      f"edges= {stats.num_edges}"
                      + self.algorithm.print_verbose_suffix())
            if not ok:
                return it
        return it + 1 if max_iterations > 0 else 0
