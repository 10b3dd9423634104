"""VQ-VAE task (port of msla_tpu/models/vqvae.py).

Training loss = embedding_loss + commitment_loss + Σᵢ L1(stemᵢ) (reference:
vqvae.py:62-66); validation/test return the reference's metric catalog
(vqvae.py:108-165); Adam(lr) (vqvae.py:168-171); the codebook is written as
CSV each epoch (vqvae.py:239-243). With ``compute_dtype="bfloat16"`` the
network runs in bf16 and the loss, metrics, VQ and Adam's parameters stay
fp32, as in the JAX task. The audio demo of the first validation batch waits
for the WAV writer (ROADMAP.md queue items 2 and 3).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from msla_tpu_torch.models.module import TaskModule
from msla_tpu_torch.nn.vqvae_net import QuantizedOutput, VQVAENet
from msla_tpu_torch.ops.metrics import l1_loss, mse_loss, si_sdr_mean

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
        header row)."""
        codebook = self.net.vector_quantizer.codebook.weight.detach().cpu().numpy()
        path = Path(self.hparams["codebook_file"])
        path.parent.mkdir(parents=True, exist_ok=True)
        header = ",".join(str(i) for i in range(codebook.shape[1]))
        np.savetxt(path, codebook, delimiter=",", header=header, comments="")

    @torch.no_grad()
    def predict_step(self, batch) -> torch.Tensor:
        mixed, _ = batch
        return self.net(mixed).output

    @torch.no_grad()
    def get_quantized(self, x: torch.Tensor) -> QuantizedOutput:
        """Inference path used by Quantize / generate."""
        return self.net.get_quantized(x)
