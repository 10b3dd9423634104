"""Data side of the port: the datamodule's device-side half and the masking augment."""
from msla_tpu_torch.data.datamodule import SlakhDataModule

__all__ = ["SlakhDataModule"]
