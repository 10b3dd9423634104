"""Slakh datamodule (port of msla_tpu/data/datamodule.py; reference:
src/data/datamodule.py:14-119).

The loaders are the JAX package's: the train split shuffled with
``drop_last``, validation and test with ``drop_last``, predict at batch 1;
each builds its ``SlakhDataset`` when called, and yields numpy batches of
(B, 4, T) stems, which the Trainer copies to the device one step ahead.
``train_transform`` (the masking augment) and ``on_after_batch_transfer``
(the mixture broadcast, or the frozen teacher's code ids or latents with a
``quantizer``) run on the batch once it is on the device. In a
data-parallel run each rank's loaders read its interleave of the data
(``process_index`` r of N: ``parallel.mesh.data_info``, the data index and
size, so model peers read the same rows), the
DistributedSampler's role, as the JAX package's do
(msla_tpu/data/datamodule.py:71-80).
"""
from __future__ import annotations

import torch

from msla_tpu_torch.data.dataset import SlakhDataset
from msla_tpu_torch.data.loader import DataLoader
from msla_tpu_torch.parallel.mesh import data_info


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
        """``quantizer`` is the frozen VQ-VAE teacher of the second stages
        (``data.transform.Quantize``): with it the model input is its code
        ids, or its quantized latents with ``quantized_latents``."""
        self.quantize = quantizer
        self.quantized_latents = quantized_latents
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

    def create_dataset(self, path: str, masking: bool = False) -> SlakhDataset:
        return SlakhDataset(path,
                            target_sample_rate=self.target_sample_rate,
                            target_sample_duration=self.target_sample_duration,
                            max_duration=self.max_duration,
                            maximum_dataset_size=self.maximum_dataset_size,
                            masking=masking)

    def _loader(self, dataset: SlakhDataset, **kw) -> DataLoader:
        rank, count = data_info()
        return DataLoader(dataset, num_workers=self.num_workers, seed=self.seed,
                          process_index=rank, process_count=count, **kw)

    def train_dataloader(self) -> DataLoader:
        return self._loader(self.create_dataset(self.train_dir, masking=self.masking),
                            batch_size=self.batch_size, shuffle=True, drop_last=True)

    def val_dataloader(self) -> DataLoader:
        return self._loader(self.create_dataset(self.val_dir),
                            batch_size=self.batch_size, shuffle=False, drop_last=True)

    def test_dataloader(self) -> DataLoader:
        return self._loader(self.create_dataset(self.test_dir),
                            batch_size=self.batch_size, shuffle=False, drop_last=True)

    def predict_dataloader(self) -> DataLoader:
        return self._loader(self.create_dataset(self.test_dir),
                            batch_size=1, shuffle=False, drop_last=False)

    def train_transform(self, batch: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """Train-only masking augmentation, on the device (the reference applies
        it per item on the CPU, dataset.py:42-49). In a data-parallel run the
        masks are drawn for the global batch and this rank takes its rows'
        (``masking_augment``'s ``shard``, the data index and size), so N data
        ranks mask as one process does at N times the batch."""
        if not self.masking:
            return batch
        from msla_tpu_torch.data.augment import masking_augment

        return masking_augment(batch, generator, shard=data_info())

    def on_after_batch_transfer(self, batch: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, 4, T) stems → (model input, target stems). Without a quantizer
        (the VQ-VAE stage) the model input is the mixture (sum over stems)
        broadcast to the encoder's 4 input channels, the documented intent of
        the reference's shape-broken einsum (datamodule.py:118-119); with one,
        the teacher's (B, W) code ids, or its (B, D, W) quantized latents
        with ``quantized_latents``."""
        if self.quantize is not None:
            if self.quantized_latents:
                return self.quantize.get_quantized(batch), batch
            return self.quantize.get_encodings_idx(batch), batch
        mixture = batch.sum(dim=1, keepdim=True)       # (B, 1, T)
        return mixture.expand_as(batch), batch
