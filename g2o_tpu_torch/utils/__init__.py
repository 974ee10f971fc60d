from g2o_tpu_torch.utils.properties import Property, PropertyMap
from g2o_tpu_torch.utils import tictoc

__all__ = ["Property", "PropertyMap", "tictoc"]
