"""The data side of the training slice on the CPU against the JAX package:
stft/istft at 1e-5 of the signal's scale (FFTs of 400 points in another
order), the masks built from JAX's own draws exactly, the masked
reconstruction at 1e-5, and the datamodule's mixture broadcast exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msla_tpu.data import augment as jax_augment
from msla_tpu.data.datamodule import SlakhDataModule as JaxSlakhDataModule
from msla_tpu.ops.stft import (hann_window as jax_hann_window, istft as jax_istft,
                               stft as jax_stft)
from msla_tpu_torch.data.augment import axis_mask, masked_reconstruction, masking_augment
from msla_tpu_torch.data.datamodule import SlakhDataModule
from msla_tpu_torch.ops.stft import hann_window, istft, stft

TOL = dict(rtol=1e-5, atol=1e-5)
DM_ARGS = dict(train_dir="t", val_dir="v", test_dir="s", target_sample_rate=22000,
               target_sample_duration=2, max_duration=120, maximum_dataset_size=100,
               batch_size=2)


def _stems(b=2, t=4000, seed=0):
    return (np.random.default_rng(seed).standard_normal((b, 4, t)) * 0.3).astype(np.float32)


def test_hann_window_matches_jax():
    np.testing.assert_allclose(hann_window(400).numpy(), np.asarray(jax_hann_window(400)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("t", [4000, 4100])
def test_stft_matches_jax(t):
    x = _stems(t=t, seed=1)
    want = np.asarray(jax_stft(jnp.asarray(x)))
    got = stft(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 4, 201, t // 200 + 1)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.real, want.real, rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(got.imag, want.imag, rtol=1e-5, atol=1e-5 * scale)


def test_istft_matches_jax_and_inverts_stft():
    x = _stems(seed=2)
    spec = np.array(jax_stft(jnp.asarray(x)))
    want = np.asarray(jax_istft(jnp.asarray(spec), length=4000))
    got = istft(torch.from_numpy(spec), length=4000).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, x, **TOL)


def _jax_draws(rng, b):
    """The uniform draws msla_tpu.data.augment._axis_mask makes from rng."""
    r_width, r_start = jax.random.split(rng)
    return (torch.from_numpy(np.array(jax.random.uniform(r_width, (b,)))),
            torch.from_numpy(np.array(jax.random.uniform(r_start, (b,)))))


@pytest.mark.parametrize("size,param", [(21, 20), (201, 80)])
def test_axis_mask_from_jax_draws_matches_jax(size, param):
    rng = jax.random.PRNGKey(3)
    want = np.asarray(jax_augment._axis_mask(rng, 8, size, param))
    got = axis_mask(*_jax_draws(rng, 8), size, param).numpy()
    np.testing.assert_array_equal(got, want)
    assert (~got).sum(axis=1).max() < param  # one span shorter than the param


def test_masking_augment_with_jax_masks_matches_jax():
    x = _stems(seed=4)
    rng = jax.random.PRNGKey(5)
    want = np.asarray(jax_augment.masking_augment(jnp.asarray(x), rng))
    r_time, r_freq = jax.random.split(rng)
    time_keep = axis_mask(*_jax_draws(r_time, 2), 21, jax_augment.TIME_MASK_PARAM)
    freq_keep = axis_mask(*_jax_draws(r_freq, 2), 201, jax_augment.FREQ_MASK_PARAM)
    got = masked_reconstruction(torch.from_numpy(x), time_keep, freq_keep).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_masking_augment_draws_from_the_generator():
    x = torch.from_numpy(_stems(seed=6))
    a = masking_augment(x, torch.Generator().manual_seed(0))
    b = masking_augment(x, torch.Generator().manual_seed(0))
    c = masking_augment(x, torch.Generator().manual_seed(1))
    assert a.shape == x.shape and a.dtype == x.dtype and torch.isfinite(a).all()
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_on_after_batch_transfer_matches_jax():
    x = _stems(seed=7)
    want_in, want_target = JaxSlakhDataModule(**DM_ARGS).on_after_batch_transfer(
        jnp.asarray(x))
    got_in, got_target = SlakhDataModule(**DM_ARGS).on_after_batch_transfer(
        torch.from_numpy(x))
    np.testing.assert_allclose(got_in.numpy(), np.asarray(want_in), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got_target.numpy(), np.asarray(want_target))


def test_train_transform_masks_only_when_asked():
    x = torch.from_numpy(_stems(seed=8))
    g = torch.Generator().manual_seed(0)
    assert SlakhDataModule(**DM_ARGS).train_transform(x, g) is x
    masked = SlakhDataModule(**DM_ARGS, masking=True).train_transform(x, g)
    assert masked.shape == x.shape and not torch.equal(masked, x)


def test_a_quantizer_waits_for_the_second_stages():
    """The second stages' input: with a quantizer (the frozen teacher) the
    model input is its code ids, or its latents with quantized_latents, and
    the target the stems as they came (tests/test_torch_bert_train.py holds a
    real teacher against JAX's)."""
    class Teacher:
        def get_encodings_idx(self, x):
            return x[:, 0, ::4].long()

        def get_quantized(self, x):
            return x[:, :2, ::4] * 2

    x = torch.from_numpy(_stems(seed=9))
    ids, target = SlakhDataModule(**DM_ARGS, quantizer=Teacher()).on_after_batch_transfer(x)
    assert torch.equal(ids, x[:, 0, ::4].long()) and target is x
    latents, _ = SlakhDataModule(**DM_ARGS, quantizer=Teacher(),
                                 quantized_latents=True).on_after_batch_transfer(x)
    assert torch.equal(latents, x[:, :2, ::4] * 2)
