"""Training loop of the port."""
from msla_tpu_torch.train.trainer import Trainer

__all__ = ["Trainer"]
