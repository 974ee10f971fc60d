"""g2o_tpu_torch — the PyTorch/CUDA port of g2o_tpu.

Sparse nonlinear least squares on graphs (SE2 and SE3 pose graphs and BAL
bundle adjustment so far), with the Levenberg-Marquardt and Gauss-Newton
loops driving tensors on one
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
from g2o_tpu_torch.core.lm_fused import (optimize_fused,  # noqa: E402
                                         optimize_fused_gn)
from g2o_tpu_torch.core.optimizer import (GaussNewton,  # noqa: E402
                                          LevenbergMarquardt,
                                          SparseOptimizer)
from g2o_tpu_torch.core.solvers import (DenseSolver,  # noqa: E402
                                        HostCholSolver, ImplicitSchurSolver,
                                        PCGSolver, SchurSolver,
                                        optimize_gn_host)
from g2o_tpu_torch.core.solvers.supernodal import (  # noqa: E402
    SupernodalCholeskySolver)

__all__ = ["Graph", "SparseOptimizer", "GaussNewton", "LevenbergMarquardt",
           "optimize_fused", "optimize_fused_gn", "DenseSolver",
           "PCGSolver", "SchurSolver", "ImplicitSchurSolver",
           "SupernodalCholeskySolver", "HostCholSolver", "optimize_gn_host"]
