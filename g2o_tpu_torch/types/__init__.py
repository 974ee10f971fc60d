"""Type libraries; importing this package registers their ``.g2o`` tags
(the analogue of loading a ``libg2o_types_*`` plugin)."""

from g2o_tpu_torch.types import (  # noqa: F401
    bal, icp, sba, sclam2d, sim3, slam2d, slam2d_addons, slam3d,
    slam3d_addons,
)

__all__ = [
    "slam2d", "slam3d", "sba", "sim3", "bal", "icp", "sclam2d",
    "slam2d_addons", "slam3d_addons",
]
