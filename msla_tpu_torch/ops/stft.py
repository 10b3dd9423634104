"""STFT, inverse STFT and mel spectrogram (port of msla_tpu/ops/stft.py).

torch.stft/istft and torchaudio's Spectrogram/InverseSpectrogram/
MelSpectrogram/AmplitudeToDB defaults, as the reference uses them (the
masking augment, dataset.py:44-49; the spectrogram plot, plotting.py:88-93):
periodic hann window, center=True with reflect padding, onesided. Any hop is
taken; istft overlap-adds the 50 % hop (the augment's) as shifted halves and
any other hop by an index add.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, device=None) -> torch.Tensor:
    """Periodic hann window (torch.hann_window's default)."""
    n = torch.arange(win_length, dtype=torch.float32, device=device)
    return 0.5 * (1.0 - torch.cos(2.0 * math.pi * n / win_length))


def stft(x: torch.Tensor, n_fft: int = 400, hop_length: int | None = None,
         center: bool = True) -> torch.Tensor:
    """Complex STFT, (..., T) → (..., F, frames), F = n_fft//2 + 1."""
    hop = hop_length or n_fft // 2
    if center:
        pad = n_fft // 2
        lead = x.shape[:-1]
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
        x = x.reshape(*lead, x.shape[-1])
    frames = x.unfold(-1, n_fft, hop) * hann_window(n_fft, x.device)  # (..., frames, n_fft)
    return torch.fft.rfft(frames, dim=-1).transpose(-1, -2)


def spectrogram(x: torch.Tensor, n_fft: int = 400, hop_length: int | None = None,
                power: float | None = 2.0) -> torch.Tensor:
    """torchaudio.transforms.Spectrogram's default surface (power spectrum)."""
    spec = stft(x, n_fft=n_fft, hop_length=hop_length)
    return spec if power is None else torch.abs(spec) ** power


def istft(spec: torch.Tensor, n_fft: int = 400, hop_length: int | None = None,
          center: bool = True, length: int | None = None) -> torch.Tensor:
    """Inverse STFT with hann-window overlap-add, (..., F, frames) → (..., T).

    Output length defaults to (frames - 1) * hop (torch.istft, center=True).
    """
    hop = hop_length or n_fft // 2
    window = hann_window(n_fft, spec.device)
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1) * window
    n_frames = frames.shape[-2]
    lead = frames.shape[:-2]
    total = n_fft + hop * (n_frames - 1)

    if hop * 2 == n_fft:
        # overlap-add at 50 %: output segment s = frames[s][:hop] + frames[s-1][hop:]
        first, second = frames[..., :hop], frames[..., hop:]
        out = F.pad(first, (0, 0, 0, 1)) + F.pad(second, (0, 0, 1, 0))  # (..., frames+1, hop)
        out = out.reshape(*lead, total)
        w2 = (window ** 2).reshape(2, hop)
        wsq = torch.cat([w2[:1], w2.sum(0).expand(n_frames - 1, hop), w2[1:]]).reshape(-1)
    else:
        idx = (torch.arange(n_frames, device=spec.device)[:, None] * hop
               + torch.arange(n_fft, device=spec.device)[None, :]).reshape(-1)
        flat = frames.reshape(-1, n_frames * n_fft)
        out = flat.new_zeros(flat.shape[0], total).index_add_(1, idx, flat).reshape(*lead, total)
        wsq = window.new_zeros(total).index_add_(0, idx, (window ** 2).repeat(n_frames))
    out = out / torch.where(wsq > 1e-11, wsq, torch.ones_like(wsq))

    if center:
        pad = n_fft // 2
        out = out[..., pad: total - pad]
    if length is not None:
        t = out.shape[-1]
        out = F.pad(out, (0, length - t)) if length > t else out[..., :length]
    return out


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int,
                   f_min: float = 0.0, f_max: float | None = None) -> np.ndarray:
    """(F, n_mels) triangular mel filterbank (torchaudio melscale_fbanks, htk)."""
    f_max = f_max or sample_rate / 2.0
    all_freqs = np.linspace(0, sample_rate // 2, n_fft // 2 + 1)
    m_pts = np.linspace(_hz_to_mel(np.asarray(f_min)), _hz_to_mel(np.asarray(f_max)), n_mels + 2)
    f_pts = _mel_to_hz(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


def mel_spectrogram(x: torch.Tensor, sample_rate: int, n_fft: int = 400,
                    hop_length: int = 160, n_mels: int = 128) -> torch.Tensor:
    """torchaudio MelSpectrogram's surface (reference: plotting.py:88-93):
    (..., T) → (..., n_mels, frames)."""
    spec = spectrogram(x, n_fft=n_fft, hop_length=hop_length, power=2.0)
    fb = torch.from_numpy(mel_filterbank(sample_rate, n_fft, n_mels)).to(spec.device)
    return torch.einsum("...ft,fm->...mt", spec, fb)


def amplitude_to_db(x: torch.Tensor, top_db: float = 80.0) -> torch.Tensor:
    """torchaudio AmplitudeToDB (power) with top_db clamping."""
    db = 10.0 * torch.log10(torch.clamp(x, min=1e-10))
    return torch.maximum(db, db.max() - top_db)
