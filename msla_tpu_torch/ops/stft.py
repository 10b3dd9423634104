"""STFT and inverse STFT (port of msla_tpu/ops/stft.py, the parts the masking
augment uses).

torch.stft/istft and torchaudio's Spectrogram/InverseSpectrogram defaults:
periodic hann window, center=True with reflect padding, onesided. Only the
50 %-overlap path (hop = n_fft / 2, the default) is ported; the mel
spectrogram waits for the slices that plot or use it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def hann_window(win_length: int, device=None) -> torch.Tensor:
    """Periodic hann window (torch.hann_window's default)."""
    n = torch.arange(win_length, dtype=torch.float32, device=device)
    return 0.5 * (1.0 - torch.cos(2.0 * math.pi * n / win_length))


def _hop(n_fft: int, hop_length: int | None) -> int:
    hop = hop_length or n_fft // 2
    if hop * 2 != n_fft:
        raise NotImplementedError(f"hop_length={hop} with n_fft={n_fft}: only the "
                                  "50 %-overlap path (hop = n_fft / 2) is ported")
    return hop


def stft(x: torch.Tensor, n_fft: int = 400, hop_length: int | None = None,
         center: bool = True) -> torch.Tensor:
    """Complex STFT, (..., T) → (..., F, frames), F = n_fft//2 + 1."""
    hop = _hop(n_fft, hop_length)
    if center:
        pad = n_fft // 2
        lead = x.shape[:-1]
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
        x = x.reshape(*lead, x.shape[-1])
    frames = x.unfold(-1, n_fft, hop) * hann_window(n_fft, x.device)  # (..., frames, n_fft)
    return torch.fft.rfft(frames, dim=-1).transpose(-1, -2)


def istft(spec: torch.Tensor, n_fft: int = 400, hop_length: int | None = None,
          center: bool = True, length: int | None = None) -> torch.Tensor:
    """Inverse STFT with hann-window overlap-add, (..., F, frames) → (..., T).

    Output length defaults to (frames - 1) * hop (torch.istft, center=True).
    """
    hop = _hop(n_fft, hop_length)
    window = hann_window(n_fft, spec.device)
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1) * window
    n_frames = frames.shape[-2]
    lead = frames.shape[:-2]
    total = n_fft + hop * (n_frames - 1)

    # overlap-add at 50 %: output segment s = frames[s][:hop] + frames[s-1][hop:]
    first, second = frames[..., :hop], frames[..., hop:]
    out = F.pad(first, (0, 0, 0, 1)) + F.pad(second, (0, 0, 1, 0))  # (..., frames+1, hop)
    out = out.reshape(*lead, total)
    w2 = (window ** 2).reshape(2, hop)
    wsq = torch.cat([w2[:1], w2.sum(0).expand(n_frames - 1, hop), w2[1:]]).reshape(-1)
    out = out / torch.where(wsq > 1e-11, wsq, torch.ones_like(wsq))

    if center:
        pad = n_fft // 2
        out = out[..., pad: total - pad]
    if length is not None:
        t = out.shape[-1]
        out = F.pad(out, (0, length - t)) if length > t else out[..., :length]
    return out
