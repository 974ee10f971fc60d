"""Linear solvers."""

from g2o_tpu_torch.core.solvers.cgls import CGLSSolver  # noqa: F401
from g2o_tpu_torch.core.solvers.dense import DenseSolver  # noqa: F401
from g2o_tpu_torch.core.solvers.host_chol import (  # noqa: F401
    HostCholSolver, optimize_gn_host)
from g2o_tpu_torch.core.solvers.pcg import PCGSolver  # noqa: F401
from g2o_tpu_torch.core.solvers.schur_implicit import (  # noqa: F401
    ImplicitSchurSolver)
from g2o_tpu_torch.core.solvers.schur import SchurSolver  # noqa: F401
from g2o_tpu_torch.core.solvers.sparse_chol import (  # noqa: F401
    SparseCholeskySolver)
from g2o_tpu_torch.core.solvers.supernodal import (  # noqa: F401
    SupernodalCholeskySolver)
