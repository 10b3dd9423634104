"""msla_tpu_torch.inference.SourceSeparator on the CPU against the JAX
SourceSeparator on the same weights, for a 9,500-sample song (4.75 frames of
2,000). Stems at rtol 1e-4, atol 1e-5; code ids equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msla_tpu.inference import SourceSeparator as JaxSourceSeparator
from msla_tpu.models.vqvae import VQVAETask as JaxVQVAETask
from msla_tpu_torch.inference import SourceSeparator
from msla_tpu_torch.models.vqvae import VQVAETask
from msla_tpu_torch.utils.jax_compat import vqvae_state_dict_from_jax

CFG = dict(num_hidden=16, num_residual_layer=2, num_residual_hidden=8, num_embedding=16,
           embedding_dim=8, commitment_cost=0.25, learning_rate=1e-3, sample_rate=1000)
FRAME = 2000
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def separators(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sep")
    paths = dict(checkpoint_dir=str(tmp), codebook_file=str(tmp / "cb.csv"))
    jax_task = JaxVQVAETask(**CFG, **paths, use_pallas=False)
    params = jax_task.net.init(jax.random.PRNGKey(1), jnp.zeros((1, 4, FRAME)))["params"]
    task = VQVAETask(**CFG, **paths, device="cpu")
    task.net.load_state_dict(vqvae_state_dict_from_jax(params, CFG["num_residual_layer"]))
    return (JaxSourceSeparator(jax_task, params, frame_samples=FRAME, batch_size=4),
            SourceSeparator(task, frame_samples=FRAME, batch_size=4))


def _song():
    return np.random.default_rng(0).standard_normal(9500).astype(np.float32)


@pytest.mark.parametrize("overlap", [False, True])
def test_separate_matches_jax(separators, overlap):
    jax_sep, sep = separators
    want = jax_sep.separate(_song(), overlap=overlap)
    got = sep.separate(_song(), overlap=overlap)
    assert got.shape == want.shape == (4, 9500) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


def test_encode_codes_matches_jax(separators):
    jax_sep, sep = separators
    want = jax_sep.encode_codes(_song())
    got = sep.encode_codes(_song())
    assert got.shape == (5, FRAME // 4) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("frame", [FRAME + 1, FRAME + 2, FRAME + 3])
def test_frame_length_must_suit_the_stem_kernel(separators, frame):
    """Any frame length is taken now, as the JAX package takes it:
    encode_codes gives JAX's floor(F/4) codes a frame, and separate, whose
    frames come back floor(F/4)·4 samples long, raises ValueError where JAX's
    raises."""
    jax_sep, sep = separators
    jax_sep = JaxSourceSeparator(jax_sep.task, jax_sep.params, frame_samples=frame,
                                 batch_size=4)
    sep = SourceSeparator(sep.task, frame_samples=frame, batch_size=4)
    got = sep.encode_codes(_song())
    assert got.shape == (-(-9500 // frame), frame // 4)
    np.testing.assert_array_equal(got, jax_sep.encode_codes(_song()))
    for overlap in (False, True):
        with pytest.raises(ValueError):
            jax_sep.separate(_song(), overlap=overlap)
        with pytest.raises(ValueError):
            sep.separate(_song(), overlap=overlap)


def test_default_device_is_the_card_and_refuses_to_fall_back():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VQVAETask(**CFG, checkpoint_dir=".", codebook_file="cb.csv")
