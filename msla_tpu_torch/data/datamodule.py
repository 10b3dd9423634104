"""Slakh datamodule, its device-side half (port of msla_tpu/data/datamodule.py).

The constructor takes the JAX package's arguments. ``train_transform`` (the
masking augment) and ``on_after_batch_transfer`` (the mixture broadcast) run
on the batch once it is on the device. The ``*_dataloader`` methods need the
WAV dataset path (dataset, loader, WAV reading, resampling), which is not
ported yet: they raise. Until then a caller subclasses this module and returns
its own loaders, any sized iterables of (B, 4, T) float32 stem batches, as the
Trainer asks no more of them.
"""
from __future__ import annotations

import torch

_DATA_PATH = ("the WAV dataset path (dataset, loader, WAV reading, resampling) waits "
              "for ROADMAP.md queue item 3, the data path and CLI; subclass "
              "SlakhDataModule with in-memory loaders meanwhile")


class SlakhDataModule:
    def __init__(self,
                 train_dir: str,
                 val_dir: str,
                 test_dir: str,
                 target_sample_rate: int,
                 target_sample_duration: int,
                 max_duration: int,
                 maximum_dataset_size: int,
                 batch_size: int,
                 persistent_workers: bool = True,
                 num_workers: int = 1,
                 pin_memory: bool = False,
                 masking: bool = False,
                 quantizer=None,
                 quantized_latents: bool = False,
                 seed: int = 0):
        """``quantizer`` (the frozen VQ-VAE teacher of the second stages) is not
        ported yet and must be None."""
        if quantizer is not None or quantized_latents:
            raise NotImplementedError("a quantizer feeds the transformer and Audio-BERT "
                                      "stages, ROADMAP.md queue items 4 and 5")
        self.train_dir = train_dir
        self.val_dir = val_dir
        self.test_dir = test_dir
        self.target_sample_rate = target_sample_rate
        self.target_sample_duration = target_sample_duration
        self.max_duration = max_duration
        self.maximum_dataset_size = maximum_dataset_size
        self.batch_size = batch_size
        self.persistent_workers = persistent_workers
        self.num_workers = num_workers
        self.pin_memory = pin_memory
        self.masking = masking
        self.seed = seed

    def train_dataloader(self):
        raise NotImplementedError(_DATA_PATH)

    def val_dataloader(self):
        raise NotImplementedError(_DATA_PATH)

    def test_dataloader(self):
        raise NotImplementedError(_DATA_PATH)

    def predict_dataloader(self):
        raise NotImplementedError(_DATA_PATH)

    def train_transform(self, batch: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """Train-only masking augmentation, on the device (the reference applies
        it per item on the CPU, dataset.py:42-49)."""
        if not self.masking:
            return batch
        from msla_tpu_torch.data.augment import masking_augment

        return masking_augment(batch, generator)

    def on_after_batch_transfer(self, batch: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, 4, T) stems → (model input, target stems). The model input is the
        mixture (sum over stems) broadcast to the encoder's 4 input channels,
        the documented intent of the reference's shape-broken einsum
        (datamodule.py:118-119)."""
        mixture = batch.sum(dim=1, keepdim=True)       # (B, 1, T)
        return mixture.expand_as(batch), batch
