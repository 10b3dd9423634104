"""VQ-VAE task (port of msla_tpu/models/vqvae.py: constructor, inference hooks).

The training hooks (loss, optimizer, eval metrics, codebook CSV, audio demo)
come with the training slice (ROADMAP.md, queue item 2).
"""
from __future__ import annotations

import torch

from msla_tpu_torch.nn.vqvae_net import QuantizedOutput, VQVAENet


class VQVAETask:
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
        and the ``seed`` of the random init. ``use_pallas=True`` selects the
        fused training VQ, which this slice does not have."""
        if use_pallas:
            raise NotImplementedError("use_pallas=True selects the fused training VQ "
                                      "kernels, ROADMAP.md queue item 2")
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
                            compute_dtype=compute_dtype,
                            device=device, seed=seed)

    @property
    def device(self) -> torch.device:
        return self.net.vector_quantizer.codebook.weight.device

    @torch.no_grad()
    def predict_step(self, batch) -> torch.Tensor:
        mixed, _ = batch
        return self.net(mixed).output

    @torch.no_grad()
    def get_quantized(self, x: torch.Tensor) -> QuantizedOutput:
        """Inference path used by Quantize / generate."""
        return self.net.get_quantized(x)
