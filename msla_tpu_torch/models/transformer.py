"""Transformer task (port of msla_tpu/models/transformer.py; reference:
src/model/transformer.py:17-209).

The frozen VQ-VAE teacher's (B, D, W) quantized latents in, the (B, 4, T)
stems out. Training loss: the sum of the four stems' MSEs
(transformer.py:44-47), plus ``moe_aux_weight`` times the Switch aux loss
summed over the layers when ``moe_experts`` > 0; dropout is live, drawn
from the step's generator. Validation and test return the reference's
metric catalog (test under the prefix "testing", ``test_mode_name``,
transformer.py:56); Adam(lr); the audio demo of the first validation batch.
``pipeline_loss_fn`` is the same loss with the decoder layers pipelined
(``parallel/pipeline.py``), dropout live on the pipeline's generators.
"""
from __future__ import annotations

import random

import torch

from msla_tpu_torch.models.demo import log_audio_demo
from msla_tpu_torch.models.module import TaskModule
from msla_tpu_torch.nn.transformer_net import TransformerQuantizerNet
from msla_tpu_torch.ops.metrics import l1_loss, mse_loss, si_sdr_mean
from msla_tpu_torch.parallel.pipeline import pipelined_transformer_apply
from msla_tpu_torch.utils.jax_compat import transformer_state_dict_from_jax

INSTRUMENTS = ("bass", "drums", "guitar", "piano")


class TransformerTask(TaskModule):
    test_mode_name = "testing"  # reference parity: transformer.py:56

    def __init__(self,
                 sample_rate: int,
                 frame_length: int,
                 learning_rate: float,
                 checkpoint_dir: str,
                 num_layers: int = 4,
                 num_heads: int = 8,
                 hidden_dim: int = 512,
                 positional_mode: str = "reference",
                 dropout: float = 0.1,
                 compute_dtype: str | None = None,
                 moe_experts: int = 0,
                 moe_selected: int = 2,
                 moe_aux_weight: float = 0.01,
                 latent_channels: int = 64,
                 *, device=None, seed: int = 0):
        """The JAX task's arguments, plus ``latent_channels`` (the teacher's
        embedding_dim, which flax infers from the first batch), ``device``
        (None → the card) and the ``seed`` of the random init."""
        output_dim = sample_rate * frame_length
        input_dim = output_dim // 4
        self.hparams = dict(sample_rate=sample_rate, frame_length=frame_length,
                            learning_rate=learning_rate, checkpoint_dir=str(checkpoint_dir),
                            num_layers=num_layers, num_heads=num_heads,
                            hidden_dim=hidden_dim, positional_mode=positional_mode,
                            dropout=dropout, compute_dtype=compute_dtype,
                            moe_experts=moe_experts, moe_selected=moe_selected,
                            moe_aux_weight=moe_aux_weight)
        self.net = TransformerQuantizerNet(input_dim=input_dim, output_dim=output_dim,
                                           hidden_dim=hidden_dim, num_layers=num_layers,
                                           num_heads=num_heads, dropout=dropout,
                                           positional_mode=positional_mode,
                                           compute_dtype=compute_dtype,
                                           moe_experts=moe_experts,
                                           moe_selected=moe_selected,
                                           latent_channels=latent_channels,
                                           device=device, seed=seed)

    def configure_optimizer(self) -> torch.optim.Optimizer:
        # the same update as optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8)
        return torch.optim.Adam(self.net.parameters(), lr=self.hparams["learning_rate"],
                                betas=(0.9, 0.999), eps=1e-8)

    def state_dict_from_jax(self, params) -> dict[str, torch.Tensor]:
        return transformer_state_dict_from_jax(params, self.hparams["num_layers"])

    def loss_fn(self, batch, generator=None):
        quantized, instruments = batch
        output, aux = self.net.run(quantized, deterministic=False, generator=generator)
        loss = sum(mse_loss(output[:, i, :], instruments[:, i, :]) for i in range(4))
        metrics = {"train/loss": loss}
        if self.hparams["moe_experts"] > 0:  # the Switch aux loss, summed over the layers
            metrics["train/moe_aux"] = aux
            loss = loss + self.hparams["moe_aux_weight"] * aux
        return loss, metrics

    supports_pipeline = True

    def pipeline_layers(self) -> list:
        return [getattr(self.net, f"layer{i}") for i in range(self.net.num_layers)]

    def pipeline_loss_fn(self, batch, generator, grid, n_micro: int):
        """``loss_fn``'s stem MSEs with the decoder layers pipelined over
        ``grid``'s model groups (msla_tpu/models/transformer.py:92-113).
        Dropout is live, each (layer, microbatch) on a generator of its own
        seeded from ``generator``: another stream than ``loss_fn``'s, so the
        two agree only at dropout 0."""
        if self.hparams["moe_experts"] > 0:
            raise ValueError("pipeline_parallel and moe_experts both occupy the mesh `model` "
                             "axis — shard the experts instead (model_parallel with MoE, see "
                             "docs/PARALLELISM.md)")
        quantized, instruments = batch
        live = generator if self.hparams["dropout"] > 0 else None
        output = pipelined_transformer_apply(self.net, quantized, grid, n_micro=n_micro,
                                             generator=live)
        loss = sum(mse_loss(output[:, i, :], instruments[:, i, :]) for i in range(4))
        return loss, {"train/loss": loss}

    def eval_metrics(self, batch, mode: str) -> dict[str, torch.Tensor]:
        """The metric catalog (reference: transformer.py:84-141)."""
        quantized, instruments = batch
        output = self.net(quantized)
        mixed_output = output.sum(dim=1)
        mixed = instruments.sum(dim=1)

        metrics = {}
        loss = 0.0
        for i, name in enumerate(INSTRUMENTS):
            pred, target = output[:, i, :], instruments[:, i, :]
            loss = loss + mse_loss(pred, target)
            metrics[f"{mode}/l2_{name}_loss"] = mse_loss(pred, target)
            metrics[f"{mode}/l1_{name}_loss"] = l1_loss(pred, target)
            metrics[f"{mode}/si_sdr_{name}_measure"] = si_sdr_mean(pred, target)
        metrics[f"{mode}/si_sdr_full_audio_measure"] = si_sdr_mean(mixed_output, mixed)
        metrics[f"{mode}/l2_full_audio_loss"] = mse_loss(mixed_output, mixed)
        metrics[f"{mode}/l1_full_audio_loss"] = l1_loss(mixed_output, mixed)
        metrics[f"{mode}/loss"] = loss
        return metrics

    @torch.no_grad()
    def predict_step(self, batch) -> torch.Tensor:
        quantized, _ = batch
        return self.net(quantized)

    @torch.no_grad()
    def on_validation_batch_end(self, trainer, batch: torch.Tensor, batch_idx: int) -> None:
        """The audio demo of one random row of the first validation batch
        (reference: transformer.py:143-204): ``batch`` is the raw (B, 4, T)
        stems on the device, and the input is rebuilt through the
        datamodule's teacher, as the JAX task does. The forward runs outside
        any guard (ROADMAP.md §3)."""
        if batch_idx != 0 or not trainer.loggers:
            return
        datamodule = getattr(trainer, "datamodule", None)
        if datamodule is None or datamodule.quantize is None:
            return
        index = random.randint(0, batch.shape[0] - 1)
        stems = batch[index:index + 1]
        decoded = self.net(datamodule.on_after_batch_transfer(stems)[0])[0]
        log_audio_demo(trainer, self.hparams["checkpoint_dir"], int(self.hparams["sample_rate"]),
                       stems[0].float().cpu().numpy(), decoded.float().cpu().numpy(),
                       "transformer")
