"""g2o_tpu_torch — the PyTorch/CUDA port of g2o_tpu.

Sparse nonlinear least squares on graphs — SE2 and SE3 pose graphs, BAL
and sba bundle adjustment — with the Gauss-Newton, Levenberg-Marquardt
and Dogleg algorithms over the dense, PCG, square-root CGLS, explicit and
implicit Schur, sparse, supernodal and host Cholesky solvers, and the
marginal covariances (``core/marginals.py``), driving tensors on one
device: the CUDA card unless the caller builds the problem with
``device="cpu"``.  The JAX package
``g2o_tpu`` is the reference every part is tested against; this package
imports neither it nor JAX.

Importing the package registers the ported ``.g2o`` types and turns TF32
off for float32 matrix products: the chunk and coarse preconditioner
matrices and the dense and Schur systems feed Cholesky factorizations,
which TF32 rounding can make indefinite.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from g2o_tpu_torch import types  # noqa: E402,F401  (registers tags)
from g2o_tpu_torch.core.graph import Graph  # noqa: E402
from g2o_tpu_torch.core.lm_fused import (  # noqa: E402
    FusedLevenbergMarquardt, optimize_fused, optimize_fused_gn)
from g2o_tpu_torch.core.optimizer import (Dogleg,  # noqa: E402
                                          GaussNewton, LevenbergMarquardt,
                                          SparseOptimizer)
from g2o_tpu_torch.core.solvers import (CGLSSolver,  # noqa: E402
                                        DenseSolver, HostCholSolver,
                                        ImplicitSchurSolver, PCGSolver,
                                        SchurSolver, SparseCholeskySolver,
                                        SupernodalCholeskySolver,
                                        optimize_gn_host)

__all__ = ["Graph", "GaussNewton", "LevenbergMarquardt",
           "FusedLevenbergMarquardt", "Dogleg", "SparseOptimizer",
           "optimize_fused", "optimize_fused_gn", "DenseSolver",
           "PCGSolver", "SchurSolver", "CGLSSolver", "SparseCholeskySolver",
           "SupernodalCholeskySolver", "ImplicitSchurSolver",
           "HostCholSolver", "optimize_gn_host"]
