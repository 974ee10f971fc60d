"""Type libraries; importing this package registers their ``.g2o`` tags."""

from g2o_tpu_torch.types import bal, sba, slam2d, slam3d  # noqa: F401
