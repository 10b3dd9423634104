"""Task-module protocol (port of msla_tpu/models/module.py), in torch's idiom.

A task module holds its network, with its weights, in ``self.net``; the
Trainer composes its hooks with the optimizer it configures. The hooks keep
the JAX package's names, without the ``params`` argument:

  training_step   → loss_fn(batch, generator) -> (loss, metrics)
  validation_step/test_step → eval_metrics(batch, mode) -> metrics
  configure_optimizers      → configure_optimizer() -> torch.optim.Optimizer
  on_train_epoch_end        → on_train_epoch_end(trainer)
"""
from __future__ import annotations

from typing import Mapping

import torch
from torch import nn


class TaskModule:
    hparams: dict
    net: nn.Module

    @property
    def device(self) -> torch.device:
        return next(self.net.parameters()).device

    def configure_optimizer(self) -> torch.optim.Optimizer:
        raise NotImplementedError

    def loss_fn(self, batch: tuple[torch.Tensor, torch.Tensor], generator: torch.Generator
                ) -> tuple[torch.Tensor, Mapping[str, torch.Tensor]]:
        raise NotImplementedError

    def eval_metrics(self, batch: tuple[torch.Tensor, torch.Tensor],
                     mode: str) -> Mapping[str, torch.Tensor]:
        raise NotImplementedError

    def on_train_epoch_end(self, trainer) -> None:
        pass
