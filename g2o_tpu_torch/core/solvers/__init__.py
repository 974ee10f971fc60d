"""Linear solvers."""

from g2o_tpu_torch.core.solvers.pcg import PCGSolver  # noqa: F401
