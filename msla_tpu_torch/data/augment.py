"""Spectrogram masking augmentation, batched on the device (port of
msla_tpu/data/augment.py; reference: src/data/dataset.py:42-49).

Spectrogram(power=2) → TimeMasking(20, iid) → FrequencyMasking(80, iid) →
ToComplex → InverseSpectrogram, on the whole batch at once:
* the spectrogram is a power spectrum cast to complex with zero phase, so the
  round trip is deliberately lossy, as in the reference;
* masks are drawn as torchaudio.functional.mask_along_axis draws them: width
  ~ U[0, param), start ~ U[0, size − width), one mask shared by the 4 stems of
  an item, another for each item.

The draws (``torch.rand`` from a ``torch.Generator``) are kept apart from the
masks built from them (``axis_mask``), so a test can feed in JAX's draws.
Under data parallelism (``shard`` = (rank r, world size N)) the draws are made
for the global batch of N·B rows from a generator every rank holds in the
same state, and the rank takes the columns of the rows it holds: r, r + N, …,
the loader's interleave.
"""
from __future__ import annotations

import torch

from msla_tpu_torch.ops.stft import istft, stft

TIME_MASK_PARAM = 20
FREQ_MASK_PARAM = 80


def axis_mask(u_width: torch.Tensor, u_start: torch.Tensor, size: int,
              mask_param: int) -> torch.Tensor:
    """(B, size) boolean keep-mask with one zero span per item, from (B,)
    uniform draws in [0, 1) for its width and its start."""
    width = torch.floor(u_width * mask_param)
    start = torch.floor(u_start * (size - width))
    pos = torch.arange(size, device=u_width.device)[None, :]
    return ~((pos >= start[:, None]) & (pos < (start + width)[:, None]))


def masked_reconstruction(batch: torch.Tensor, time_keep: torch.Tensor,
                          freq_keep: torch.Tensor) -> torch.Tensor:
    """(B, 4, T) stems, (B, frames) and (B, F) keep-masks → the masked lossy
    reconstruction, same shape."""
    spec = torch.abs(stft(batch)) ** 2.0                  # (B, 4, F, frames)
    spec = spec * time_keep[:, None, None, :] * freq_keep[:, None, :, None]
    return istft(spec.to(torch.complex64), length=batch.shape[-1]).to(batch.dtype)


def masking_augment(batch: torch.Tensor, generator: torch.Generator,
                    time_mask_param: int = TIME_MASK_PARAM,
                    freq_mask_param: int = FREQ_MASK_PARAM,
                    n_fft: int = 400, shard: tuple[int, int] = (0, 1)) -> torch.Tensor:
    """(B, 4, T) stems → masked lossy-reconstructed stems, same shape."""
    b, t = batch.shape[0], batch.shape[-1]
    n_frames, f_bins = t // (n_fft // 2) + 1, n_fft // 2 + 1   # center=True framing
    rank, world = shard
    u = torch.rand((4, b * world), generator=generator, device=batch.device)
    if world > 1:
        u = u[:, rank::world]
    time_keep = axis_mask(u[0], u[1], n_frames, time_mask_param)
    freq_keep = axis_mask(u[2], u[3], f_bins, freq_mask_param)
    return masked_reconstruction(batch, time_keep, freq_keep)
