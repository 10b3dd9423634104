"""The port's ops/stft.py at any hop, and the mel spectrogram, against
msla_tpu/ops/stft.py on the CPU: stft and istft within 1e-5 of the signal's
scale (FFTs of 400 points in another order), the mel filterbank bit for bit
(the same numpy), the mel spectrogram at rtol 1e-5 of its scale and its dB
at atol 1e-5·80 dB (one part in 1e5 of the clamped range, after a log that
magnifies the power's rounding at most 10/ln 10 · 1e-5). The masking
augment's 50 % path gives the bits it gave before the general hop was ported:
a frozen copy of that code, below, is the reference."""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from msla_tpu_torch.data.augment import masked_reconstruction, masking_augment
from msla_tpu_torch.ops.stft import (amplitude_to_db, hann_window, istft, mel_filterbank,
                                     mel_spectrogram, spectrogram, stft)

jax_stft = importlib.import_module("msla_tpu.ops.stft")  # msla_tpu.ops.stft is also a function


def _signal(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3).astype(np.float32)


def _close(got, want, scale):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("n_fft,hop", [(400, 160), (400, 100), (400, 128), (256, 64),
                                       (400, 200)])
@pytest.mark.parametrize("t", [4000, 4123])
def test_stft_at_any_hop_matches_jax(n_fft, hop, t):
    x = _signal((2, 3, t), seed=hop + t)
    want = np.asarray(jax_stft.stft(jnp.asarray(x), n_fft=n_fft, hop_length=hop))
    got = stft(torch.from_numpy(x), n_fft=n_fft, hop_length=hop).numpy()
    assert got.shape == want.shape == (2, 3, n_fft // 2 + 1, t // hop + 1)
    scale = np.abs(want).max()
    _close(got.real, want.real, scale)
    _close(got.imag, want.imag, scale)


@pytest.mark.parametrize("n_fft,hop", [(400, 160), (400, 100), (400, 128), (256, 64)])
def test_istft_at_any_hop_matches_jax_and_inverts_stft(n_fft, hop):
    x = _signal((2, 4000), seed=hop)
    spec = np.array(jax_stft.stft(jnp.asarray(x), n_fft=n_fft, hop_length=hop))
    want = np.asarray(jax_stft.istft(jnp.asarray(spec), n_fft=n_fft, hop_length=hop,
                                     length=4000))
    got = istft(torch.from_numpy(spec), n_fft=n_fft, hop_length=hop, length=4000).numpy()
    _close(got, want, np.abs(want).max())
    cover = hop * (4000 // hop)  # the samples the frames reach; JAX's and torch's pad the rest
    _close(got[:, :cover], x[:, :cover], np.abs(x).max())
    short = istft(torch.from_numpy(spec), n_fft=n_fft, hop_length=hop).numpy()
    want_short = np.asarray(jax_stft.istft(jnp.asarray(spec), n_fft=n_fft, hop_length=hop))
    assert short.shape == want_short.shape
    _close(short, want_short, np.abs(want).max())


@pytest.mark.parametrize("sr,n_fft,n_mels", [(22000, 400, 128), (4000, 400, 64),
                                             (44100, 1024, 80)])
def test_mel_filterbank_is_jax_bit_for_bit(sr, n_fft, n_mels):
    got = mel_filterbank(sr, n_fft, n_mels)
    assert got.shape == (n_fft // 2 + 1, n_mels) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_stft.mel_filterbank(sr, n_fft, n_mels))


@pytest.mark.parametrize("sr,t", [(22000, 44000), (4000, 8000)])
def test_mel_spectrogram_and_db_match_jax(sr, t):
    x = _signal((1, t), seed=sr)
    want = np.asarray(jax_stft.mel_spectrogram(jnp.asarray(x), sample_rate=sr, n_fft=400,
                                               hop_length=160, n_mels=128))
    got = mel_spectrogram(torch.from_numpy(x), sample_rate=sr, n_fft=400, hop_length=160,
                          n_mels=128).numpy()
    assert got.shape == want.shape == (1, 128, t // 160 + 1)
    _close(got, want, np.abs(want).max())
    want_db = np.asarray(jax_stft.amplitude_to_db(jnp.asarray(want)))
    got_db = amplitude_to_db(torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(got_db, want_db, rtol=0, atol=1e-5 * 80.0)
    assert got_db.max() - got_db.min() <= 80.0 + 1e-4


def test_spectrogram_power_and_complex():
    x = torch.from_numpy(_signal((2, 1000), seed=3))
    assert torch.equal(spectrogram(x, power=None), stft(x))
    assert torch.equal(spectrogram(x, hop_length=100), torch.abs(stft(x, hop_length=100)) ** 2)


# ---- the 50 % path as it was before the general hop (frozen reference) ----

def _stft_before(x, n_fft=400):
    hop = n_fft // 2
    pad = n_fft // 2
    lead = x.shape[:-1]
    x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
    x = x.reshape(*lead, x.shape[-1])
    n = torch.arange(n_fft, dtype=torch.float32)
    window = 0.5 * (1.0 - torch.cos(2.0 * math.pi * n / n_fft))
    return torch.fft.rfft(x.unfold(-1, n_fft, hop) * window, dim=-1).transpose(-1, -2)


def _istft_before(spec, length, n_fft=400):
    hop = n_fft // 2
    n = torch.arange(n_fft, dtype=torch.float32)
    window = 0.5 * (1.0 - torch.cos(2.0 * math.pi * n / n_fft))
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1) * window
    n_frames = frames.shape[-2]
    lead = frames.shape[:-2]
    total = n_fft + hop * (n_frames - 1)
    first, second = frames[..., :hop], frames[..., hop:]
    out = F.pad(first, (0, 0, 0, 1)) + F.pad(second, (0, 0, 1, 0))
    out = out.reshape(*lead, total)
    w2 = (window ** 2).reshape(2, hop)
    wsq = torch.cat([w2[:1], w2.sum(0).expand(n_frames - 1, hop), w2[1:]]).reshape(-1)
    out = out / torch.where(wsq > 1e-11, wsq, torch.ones_like(wsq))
    out = out[..., n_fft // 2: total - n_fft // 2]
    t = out.shape[-1]
    return F.pad(out, (0, length - t)) if length > t else out[..., :length]


@pytest.mark.parametrize("t", [4000, 4100])
def test_the_augments_half_overlap_path_gives_the_same_bits(t):
    x = torch.from_numpy(_signal((2, 4, t), seed=t))
    assert torch.equal(stft(x), _stft_before(x))
    spec = (torch.abs(stft(x)) ** 2.0).to(torch.complex64)
    assert torch.equal(istft(spec, length=t), _istft_before(spec, t))
    assert torch.equal(hann_window(400), 0.5 * (1.0 - torch.cos(
        2.0 * math.pi * torch.arange(400, dtype=torch.float32) / 400)))
    time_keep = torch.rand(2, t // 200 + 1, generator=torch.Generator().manual_seed(0)) > 0.2
    freq_keep = torch.rand(2, 201, generator=torch.Generator().manual_seed(1)) > 0.2
    want_spec = (torch.abs(_stft_before(x)) ** 2.0) * time_keep[:, None, None, :] \
        * freq_keep[:, None, :, None]
    want = _istft_before(want_spec.to(torch.complex64), t)
    assert torch.equal(masked_reconstruction(x, time_keep, freq_keep), want)
    a = masking_augment(x, torch.Generator().manual_seed(5))
    b = masking_augment(x, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
