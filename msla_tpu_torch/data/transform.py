"""The frozen VQ-VAE teacher of the second stages (port of
msla_tpu/data/transform.py; reference: src/data/transform.py:5-23).

``Quantize`` wraps a trained VQ-VAE so that the transformer and Audio-BERT
stages train on its quantized latents or code ids. It runs inside the train
step, on the batch already on the device, under ``torch.no_grad()``: the
JAX package's ``stop_gradient`` (not ``inference_mode``, whose tensors could
not enter the step's autograd graph).
"""
from __future__ import annotations

import torch


class Quantize:
    """Callable teacher over a ``VQVAETask`` or a ``VQVAENet``."""

    def __init__(self, task_or_net):
        self.net = getattr(task_or_net, "net", task_or_net)

    @torch.no_grad()
    def get_quantized(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 4, T) stems → (B, embedding_dim, W) quantized latents."""
        return self.net.get_quantized(x).quantized

    @torch.no_grad()
    def get_encodings_idx(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 4, T) stems → (B, W) codebook indices."""
        return self.net.get_quantized(x).encoding_indices


class ToComplex:
    """Cast to complex64 (reference: transform.py:19-23), between the masked
    power spectrogram and the inverse STFT."""

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.complex64)
