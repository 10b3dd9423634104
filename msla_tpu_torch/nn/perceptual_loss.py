"""Perceptual loss (port of msla_tpu/nn/perceptual_loss.py).

MSE between VGG16 feature maps of mel spectrograms (n_fft=400, hop=160,
n_mels=64), the spectrogram replicated to 3 channels. Like the JAX package's,
an optional capability that no default training loss uses. The gradient
reaches the waveforms (``x``, and ``target`` if it requires one), never the
frozen VGG weights; the convs' adjoints run in fp32 wherever ``backward()``
is called (``nn/vgg.py``).
"""
from __future__ import annotations

from typing import Mapping

import torch

from msla_tpu_torch.nn.vgg import VGG16Features
from msla_tpu_torch.ops.stft import mel_spectrogram


class PerceptualLoss:
    def __init__(self, sample_rate: int, state_dict: Mapping[str, torch.Tensor] | None = None,
                 generator: torch.Generator | None = None, device=None):
        """``state_dict``: VGG16Features' (``features.*``, torchvision's
        keys; ``utils.jax_compat.vgg16_state_dict_from_jax`` maps the JAX
        package's params), loaded strictly; without it the weights are
        random, drawn from ``generator`` (one seeded with 0 if None).
        ``device`` None means the card."""
        self.sample_rate = int(sample_rate)
        self.net = VGG16Features(generator=generator, device=device)
        if state_dict is not None:
            self.net.load_state_dict(state_dict, strict=True)

    def _features(self, waveform: torch.Tensor) -> torch.Tensor:
        mel = mel_spectrogram(waveform, sample_rate=self.sample_rate,
                              n_fft=400, hop_length=160, n_mels=64)  # (..., 64, T')
        img = mel.unsqueeze(-3).expand(*mel.shape[:-2], 3, *mel.shape[-2:])  # NCHW
        if img.ndim == 3:
            img = img[None]
        return self.net(img)

    def __call__(self, x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """Mean of the squared differences of both waveforms' VGG16
        features over all elements: a 0-d tensor (fp32 on fp32 waveforms)."""
        return torch.mean((self._features(x) - self._features(target)) ** 2)
