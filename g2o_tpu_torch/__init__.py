"""g2o_tpu_torch — the PyTorch/CUDA port of g2o_tpu.

Sparse nonlinear least squares on graphs (pose graphs first), with the
Levenberg-Marquardt loop driving tensors on one device.  The JAX package
``g2o_tpu`` is the reference every part is tested against; this package
imports neither it nor JAX.

Importing the package registers the ported ``.g2o`` types and turns TF32
off for float32 matrix products: the chunk and coarse preconditioner
matrices feed Cholesky factorizations, which TF32 rounding can make
indefinite.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from g2o_tpu_torch import types  # noqa: E402,F401  (registers tags)
from g2o_tpu_torch.core.graph import Graph  # noqa: E402
from g2o_tpu_torch.core.lm_fused import optimize_fused  # noqa: E402
from g2o_tpu_torch.core.optimizer import (LevenbergMarquardt,  # noqa: E402
                                          SparseOptimizer)
from g2o_tpu_torch.core.solvers.pcg import PCGSolver  # noqa: E402

__all__ = ["Graph", "SparseOptimizer", "LevenbergMarquardt",
           "optimize_fused", "PCGSolver"]
