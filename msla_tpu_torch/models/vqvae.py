"""VQ-VAE task (port of msla_tpu/models/vqvae.py).

Training loss = embedding_loss + commitment_loss + Σᵢ L1(stemᵢ) (reference:
vqvae.py:62-66); validation/test return the reference's metric catalog
(vqvae.py:108-165); Adam(lr) (vqvae.py:168-171); the codebook is written as
CSV each epoch (vqvae.py:239-243); the audio demo of the first validation
batch is written when the trainer has a logger (vqvae.py:173-237). With
``compute_dtype="bfloat16"`` the network runs in bf16 and the loss, metrics,
VQ and Adam's parameters stay fp32, as in the JAX task.
"""
from __future__ import annotations

import random
from pathlib import Path

import numpy as np
import torch

from msla_tpu_torch.models.demo import log_audio_demo
from msla_tpu_torch.models.module import TaskModule
from msla_tpu_torch.nn.vqvae_net import QuantizedOutput, VQVAENet
from msla_tpu_torch.ops.metrics import l1_loss, mse_loss, si_sdr_mean
from msla_tpu_torch.parallel.mesh import is_main_process
from msla_tpu_torch.utils.jax_compat import vqvae_state_dict_from_jax

INSTRUMENTS = ("bass", "drums", "guitar", "piano")


class VQVAETask(TaskModule):
    def __init__(self,
                 num_hidden: int,
                 num_residual_layer: int,
                 num_residual_hidden: int,
                 num_embedding: int,
                 embedding_dim: int,
                 commitment_cost: float,
                 learning_rate: float,
                 sample_rate: int,
                 checkpoint_dir: str,
                 codebook_file: str,
                 use_pallas: bool | None = None,
                 compute_dtype: str | None = None,
                 *, device=None, seed: int = 0):
        """Same arguments as the JAX task, plus ``device`` (None → the card)
        and the ``seed`` of the random init. ``use_pallas`` None or True trains
        through the fused VQ kernels, False through the lookup VQ."""
        self.hparams = dict(num_hidden=num_hidden, num_residual_layer=num_residual_layer,
                            num_residual_hidden=num_residual_hidden,
                            num_embedding=num_embedding, embedding_dim=embedding_dim,
                            commitment_cost=commitment_cost, learning_rate=learning_rate,
                            sample_rate=sample_rate, checkpoint_dir=str(checkpoint_dir),
                            codebook_file=str(codebook_file),
                            compute_dtype=compute_dtype)
        self.net = VQVAENet(num_hidden=num_hidden,
                            num_residual_layer=num_residual_layer,
                            num_residual_hidden=num_residual_hidden,
                            num_embedding=num_embedding,
                            embedding_dim=embedding_dim,
                            commitment_cost=commitment_cost,
                            use_pallas=use_pallas,
                            compute_dtype=compute_dtype,
                            device=device, seed=seed)

    def configure_optimizer(self) -> torch.optim.Optimizer:
        # the same update as optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8)
        return torch.optim.Adam(self.net.parameters(), lr=self.hparams["learning_rate"],
                                betas=(0.9, 0.999), eps=1e-8)

    def state_dict_from_jax(self, params) -> dict[str, torch.Tensor]:
        return vqvae_state_dict_from_jax(params, self.hparams["num_residual_layer"])

    def loss_fn(self, batch, generator=None):
        mixed, instruments = batch
        out = self.net(mixed)
        loss = out.embedding_loss + out.commitment_loss
        for i in range(4):
            loss = loss + l1_loss(out.output[:, i, :], instruments[:, i, :])
        return loss, {"train/loss": loss, "train/perplexity": out.perplexity}

    def eval_metrics(self, batch, mode: str) -> dict[str, torch.Tensor]:
        """Validation/test metric catalog (reference: vqvae.py:95-166)."""
        mixture, instruments = batch
        out = self.net(mixture)

        original_mixture = instruments.sum(dim=1)
        mixed_output = out.output.sum(dim=1)

        metrics = {
            f"{mode}/embedding_loss": out.embedding_loss,
            f"{mode}/commitment_loss": out.commitment_loss,
            f"{mode}/perplexity": out.perplexity,
        }
        loss = out.embedding_loss + out.commitment_loss
        for i, name in enumerate(INSTRUMENTS):
            pred, target = out.output[:, i, :], instruments[:, i, :]
            loss = loss + l1_loss(pred, target)
            metrics[f"{mode}/l2_{name}_loss"] = mse_loss(pred, target)
            metrics[f"{mode}/l1_{name}_loss"] = l1_loss(pred, target)
            metrics[f"{mode}/si_sdr_{name}_measure"] = si_sdr_mean(pred, target)
        metrics[f"{mode}/si_sdr_full_audio_measure"] = si_sdr_mean(mixed_output,
                                                                   original_mixture)
        metrics[f"{mode}/l2_full_audio_loss"] = mse_loss(mixed_output, original_mixture)
        metrics[f"{mode}/l1_full_audio_loss"] = l1_loss(mixed_output, original_mixture)
        metrics[f"{mode}/loss"] = loss
        return metrics

    def on_train_epoch_end(self, trainer) -> None:
        """Write the codebook as CSV with an integer header row, as the JAX
        package does (msla_tpu/models/vqvae.py:114-132: the readers skip one
        header row). Rank 0 alone writes it: every rank holds the same
        codebook (msla_tpu/models/vqvae.py:124-126)."""
        if not is_main_process():
            return
        codebook = self.net.vector_quantizer.codebook.weight.detach().cpu().numpy()
        path = Path(self.hparams["codebook_file"])
        path.parent.mkdir(parents=True, exist_ok=True)
        header = ",".join(str(i) for i in range(codebook.shape[1]))
        np.savetxt(path, codebook, delimiter=",", header=header, comments="")

    @torch.no_grad()
    def on_validation_batch_end(self, trainer, batch: torch.Tensor, batch_idx: int) -> None:
        """The audio demo of one random row of the first validation batch, the
        raw (B, 4, T) stems on the device (reference: vqvae.py:173-237)."""
        if batch_idx != 0 or not trainer.loggers:
            return
        index = random.randint(0, batch.shape[0] - 1)
        stems = batch[index:index + 1]
        decoded = self.net(stems.sum(dim=1, keepdim=True).expand_as(stems)).output[0]
        log_audio_demo(trainer, self.hparams["checkpoint_dir"], int(self.hparams["sample_rate"]),
                       stems[0].float().cpu().numpy(), decoded.float().cpu().numpy(), "vqvae")

    @torch.no_grad()
    def predict_step(self, batch) -> torch.Tensor:
        mixed, _ = batch
        return self.net(mixed).output

    @torch.no_grad()
    def get_quantized(self, x: torch.Tensor) -> QuantizedOutput:
        """Inference path used by Quantize / generate."""
        return self.net.get_quantized(x)
