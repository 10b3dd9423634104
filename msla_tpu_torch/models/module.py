"""Task-module protocol (port of msla_tpu/models/module.py), in torch's idiom.

A task module holds its network, with its weights, in ``self.net``; the
Trainer composes its hooks with the optimizer it configures. The hooks keep
the JAX package's names, without the ``params`` argument:

  training_step   → loss_fn(batch, generator) -> (loss, metrics)
  validation_step/test_step → eval_metrics(batch, mode) -> metrics
  configure_optimizers      → configure_optimizer() -> torch.optim.Optimizer
  on_train_epoch_end        → on_train_epoch_end(trainer)
  on_validation_batch_end   → on_validation_batch_end(trainer, batch, batch_idx)

``supports_pipeline`` and ``pipeline_loss_fn(batch, generator, grid,
n_micro)`` are the loss with the task's layer stack pipelined over the rank
grid's model groups (``parallel/pipeline.py``; the Trainer's
``pipeline_parallel``), ``pipeline_layers`` that stack.
``frozen_param_keys`` names the top-level parts of ``net``'s state that
training never changes (checkpoints keep them in a sidecar),
``state_dict_from_jax`` maps a JAX checkpoint's flax params to ``net``'s
state_dict, and ``optimizer_state_from_jax`` its optax state to the torch
optimizer's.
"""
from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from msla_tpu_torch.utils.jax_compat import adam_state_from_jax


class TaskModule:
    hparams: dict
    net: nn.Module
    frozen_param_keys: tuple[str, ...] = ()

    @property
    def device(self) -> torch.device:
        return next(self.net.parameters()).device

    def configure_optimizer(self) -> torch.optim.Optimizer:
        raise NotImplementedError

    def state_dict_from_jax(self, params: Mapping) -> dict[str, torch.Tensor]:
        raise NotImplementedError(f"{type(self).__name__} reads no JAX checkpoint")

    def optimizer_state_from_jax(self, optimizer: torch.optim.Optimizer,
                                 opt_state: Mapping) -> dict:
        """The state_dict for ``optimizer`` of a JAX checkpoint's
        ``opt_state``: ``optax.adam``'s, a chain whose first entry ("0") is
        ``ScaleByAdamState``."""
        return adam_state_from_jax(optimizer, self.net, opt_state["0"], self.state_dict_from_jax)

    def loss_fn(self, batch: tuple[torch.Tensor, torch.Tensor], generator: torch.Generator
                ) -> tuple[torch.Tensor, Mapping[str, torch.Tensor]]:
        raise NotImplementedError

    def eval_metrics(self, batch: tuple[torch.Tensor, torch.Tensor],
                     mode: str) -> Mapping[str, torch.Tensor]:
        raise NotImplementedError

    #: True (with pipeline_loss_fn and pipeline_layers) on tasks whose layer
    #: stack trains pipeline-parallel (msla_tpu/models/module.py:42-51)
    supports_pipeline: bool = False

    def pipeline_loss_fn(self, batch, generator: torch.Generator | None, grid, n_micro: int
                         ) -> tuple[torch.Tensor, Mapping[str, torch.Tensor]]:
        """``loss_fn`` with the layer stack pipelined over ``grid``'s model
        groups (``parallel/pipeline.py``), ``n_micro`` microbatches."""
        raise NotImplementedError(f"{type(self).__name__} has no pipeline-parallel path")

    def pipeline_layers(self) -> list[nn.Module]:
        """The pipelined layer stack, in order: stage s holds its L/pp."""
        raise NotImplementedError(f"{type(self).__name__} has no pipeline-parallel path")

    def on_train_epoch_end(self, trainer) -> None:
        pass

    def on_validation_batch_end(self, trainer, batch: torch.Tensor, batch_idx: int) -> None:
        pass
