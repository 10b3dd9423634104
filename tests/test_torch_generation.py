"""msla_tpu_torch.inference.AudioGenerator on the CPU against
msla_tpu.inference.AudioGenerator on the same weights and seeds: a small
VQ-VAE (hidden 16, K = 16, D = 8) and a small Audio-BERT (vocab 120, hidden 32,
1 layer, 2 heads) at W = 500 codes (T = 2,000 samples).

``corrupt_and_generate`` and ``decode_codes`` stems at rtol 1e-4, atol 1e-5
(the VQ-VAE's convs and BERT's sums in another order); ``sample_codes`` (with
and without a prompt) and ``generate_waveform``'s codes equal. The sampler's
jitter (1e-6 · N(0, 1), drawn from the same numpy seed on both sides) decides
the order only where two confidences are within about 1e-6; the port's
confidences are within 1e-5 of JAX's (``test_torch_audio_bert.py``), and at
these seeds the first round's kept and dropped positions are further apart
than that, which ``test_no_confidence_gap_near_the_jitter_scale`` checks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msla_tpu.inference import AudioGenerator as JaxAudioGenerator
from msla_tpu.models.bert import AudioBertTask as JaxAudioBertTask
from msla_tpu.models.vqvae import VQVAETask as JaxVQVAETask
from msla_tpu.nn.bert import BertConfig as JaxBertConfig
from msla_tpu.nn.bert import BertForMaskedLM as JaxBertForMaskedLM
from msla_tpu_torch.inference import AudioGenerator
from msla_tpu_torch.models.bert import AudioBertTask
from msla_tpu_torch.models.vqvae import VQVAETask
from msla_tpu_torch.nn.bert import BertConfig
from msla_tpu_torch.utils.jax_compat import (audio_bert_state_dict_from_jax,
                                             vqvae_state_dict_from_jax)

K_CODES, DIM, SR, W = 16, 8, 1000, 500
SMALL = dict(vocab_size=120, hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
             intermediate_size=64)
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def generators(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gen")
    cb_path = tmp / "cb.csv"
    vq_args = (16, 1, 8, K_CODES, DIM, 0.25, 1e-3, SR, str(tmp), str(cb_path))
    jax_vq = JaxVQVAETask(*vq_args, use_pallas=False)
    vq_params = jax_vq.net.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4 * W)))["params"]
    codebook = np.asarray(vq_params["vector_quantizer"]["codebook"])
    np.savetxt(cb_path, codebook, delimiter=",", header=",".join(map(str, range(DIM))),
               comments="")
    vq = VQVAETask(*vq_args, device="cpu")
    vq.net.load_state_dict(vqvae_state_dict_from_jax(vq_params, 1))

    bert_args = (2e-4, str(tmp), str(cb_path), SR, 2, K_CODES)
    jax_bert = JaxAudioBertTask(*bert_args)
    jax_bert.config = JaxBertConfig(**SMALL)
    jax_bert.bert = JaxBertForMaskedLM(jax_bert.config)
    bert_params = jax_bert.init_variables(
        jax.random.PRNGKey(1), (jnp.zeros((1, W), jnp.int32), jnp.zeros((1, 4, 4 * W))))["params"]
    bert = AudioBertTask(*bert_args, device="cpu", config=BertConfig(**SMALL))
    bert.net.load_state_dict(audio_bert_state_dict_from_jax(
        jax.tree.map(np.asarray, bert_params)))
    return (JaxAudioGenerator(jax_bert, bert_params, jax_vq, vq_params),
            AudioGenerator(bert, vq))


def _stems(b=2, seed=0):
    return (0.3 * np.random.default_rng(seed).standard_normal((b, 4, 4 * W))).astype(np.float32)


def test_corrupt_and_generate_matches_jax(generators):
    jax_gen, gen = generators
    want = jax_gen.corrupt_and_generate(_stems(), 1, rng=np.random.default_rng(5))
    got = gen.corrupt_and_generate(_stems(), 1, rng=np.random.default_rng(5))
    assert got.shape == (2, 4, 4 * W) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


def test_decode_codes_matches_jax(generators):
    jax_gen, gen = generators
    codes = np.random.default_rng(2).integers(0, K_CODES, (2, W))
    np.testing.assert_allclose(gen.decode_codes(codes), jax_gen.decode_codes(codes), **TOL)


def _prompt():
    prompt = np.full((2, W), -1, np.int64)
    prompt[:, :100] = 7
    prompt[1, 300:320] = 3
    return prompt


@pytest.mark.parametrize("prompted", [False, True])
def test_sample_codes_match_jax(generators, prompted):
    jax_gen, gen = generators
    prompt = _prompt() if prompted else None
    want = jax_gen.sample_codes(width=W, batch=2, rounds=3, seed=4, prompt=prompt)
    got = gen.sample_codes(width=W, batch=2, rounds=3, seed=4, prompt=prompt)
    assert got.shape == (2, W) and got.dtype == np.int64
    assert got.min() >= 0 and got.max() < K_CODES
    np.testing.assert_array_equal(got, want)
    if prompted:
        np.testing.assert_array_equal(got[:, :100], 7)
        np.testing.assert_array_equal(got[1, 300:320], 3)


def test_generate_waveform_matches_jax(generators):
    jax_gen, gen = generators
    want = jax_gen.generate_waveform(width=W, batch=1, rounds=2, seed=2)
    got = gen.generate_waveform(width=W, batch=1, rounds=2, seed=2)
    assert got.shape == (1, 4, 4 * W) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("prompted", [False, True])
def test_no_confidence_gap_near_the_jitter_scale(generators, prompted):
    """Replays the sampler's first round on the port: the kept and the dropped
    positions are separated by a confidence gap far above both the jitter
    (1e-6) and the port's distance from JAX's confidences, so the two
    packages keep the same positions for a reason, not by luck."""
    _, gen = generators
    prompt = _prompt() if prompted else np.full((2, W), -1, np.int64)
    tokens = torch.from_numpy(np.where(prompt < 0, gen.bert_task.config.mask_token_id, prompt))
    conf = gen.bert_task.code_proposals(tokens)[..., 1].numpy()
    rng = np.random.default_rng(4)
    for b in range(2):
        unk = np.flatnonzero(prompt[b] < 0)
        key = -conf[b, unk] + 1e-6 * rng.standard_normal(unk.size)
        order = np.sort(key)
        n_keep = max(1, int(unk.size / 3))
        assert order[n_keep] - order[n_keep - 1] > 1e-5
