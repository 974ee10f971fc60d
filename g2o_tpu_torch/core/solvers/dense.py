"""Dense Cholesky linear solver — port of ``g2o_tpu/core/solvers/dense.py``
(reference ``LinearSolverDense``, ``g2o/solvers/dense/linear_solver_dense.h:46``).

Assembles the tangent-space Hessian as a dense ``(T, T)`` matrix
(:meth:`Problem.dense_hessian_fn`) and factors ``H + λI`` with
``torch.linalg.cholesky_ex``.  A factor that is not positive definite
becomes NaN, so the LM trial is rejected instead of raising."""

from __future__ import annotations

import torch

from g2o_tpu_torch.ops.smallblocks import cholesky_or_nan


def cholesky_solve_or_nan(A, b):
    """Solve ``A x = b`` for SPD ``A (n, n)``, ``b (n,)`` by Cholesky; a
    non-positive-definite ``A`` gives a NaN ``x`` (no host sync)."""
    return torch.cholesky_solve(b[:, None], cholesky_or_nan(A))[:, 0]


class DenseSolver:
    name = "dense"

    def __init__(self):
        self.aux = ()  # no solver-owned arrays

    def setup(self, problem, force: bool = False):
        """Bind the solve to ``problem``; it reads the problem's tensors
        at every solve, so ``force`` changes nothing."""
        def solve(data, lin, lam, aux=()):
            H = problem.dense_hessian_fn(data, lin)
            # LM damping: H + lambda I on the diagonal (reference
            # ``BlockSolver::setLambda``, ``g2o/core/block_solver.hpp:525``)
            H.diagonal().add_(lam)
            return cholesky_solve_or_nan(H, lin.b)

        self._solve_fn = solve
        return self

    def solve(self, data, lin, lam=0.0):
        return self._solve_fn(data, lin, lam, self.aux)
