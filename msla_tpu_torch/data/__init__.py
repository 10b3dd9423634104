"""Data side of the port: WAV codec, resampling, the C++ IO binding, the
Slakh dataset, loader and datamodule, and the masking augment."""
from msla_tpu_torch.data.datamodule import SlakhDataModule
from msla_tpu_torch.data.dataset import SlakhDataset, make_fixture_dataset
from msla_tpu_torch.data.loader import DataLoader
from msla_tpu_torch.data.resample import resample
from msla_tpu_torch.data.wavio import read_wav, write_wav

__all__ = ["DataLoader", "SlakhDataModule", "SlakhDataset", "make_fixture_dataset",
           "read_wav", "resample", "write_wav"]
