"""The two serving entry points with compute_dtype="bfloat16" on the CPU against
the JAX package's bf16 ones on the same weights and seeds: a small VQ-VAE
(hidden 16, K = 16, D = 8) and a small Audio-BERT (vocab 120, hidden 32,
1 layer, 2 heads) at W = 500 codes (T = 2,000 samples).

``SourceSeparator.separate`` (plain and overlap) and ``decode_codes`` within
0.02 of the output's scale (measured: 0.54 % and 0.69 %, bf16 roundings after
sums in other orders; JAX's own bf16 test allows 0.08·scale against fp32);
``encode_codes`` and ``sample_codes`` at least 95 % equal (measured: all).
``corrupt_and_generate`` within 0.02 of its scale: at these seeds every VQ
code and vocab id agrees (measured error 1.8e-7, the fp32 head's), and
``tests/test_torch_bf16_bert.py`` holds the ids where they may part."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from msla_tpu.inference import AudioGenerator as JaxAudioGenerator
from msla_tpu.inference import SourceSeparator as JaxSourceSeparator
from msla_tpu.models.bert import AudioBertTask as JaxAudioBertTask
from msla_tpu.models.vqvae import VQVAETask as JaxVQVAETask
from msla_tpu.nn.bert import BertConfig as JaxBertConfig
from msla_tpu.nn.bert import BertForMaskedLM as JaxBertForMaskedLM
from msla_tpu_torch.inference import AudioGenerator, SourceSeparator
from msla_tpu_torch.models.bert import AudioBertTask
from msla_tpu_torch.models.vqvae import VQVAETask
from msla_tpu_torch.nn.bert import BertConfig
from msla_tpu_torch.utils.jax_compat import (audio_bert_state_dict_from_jax,
                                             vqvae_state_dict_from_jax)

K_CODES, DIM, SR, W = 16, 8, 1000, 500
SMALL = dict(vocab_size=120, hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
             intermediate_size=64)
BF16 = dict(compute_dtype="bfloat16")
SCALE_TOL = 0.02


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bf16")
    cb_path = tmp / "cb.csv"
    vq_args = (16, 1, 8, K_CODES, DIM, 0.25, 1e-3, SR, str(tmp), str(cb_path))
    jax_vq = JaxVQVAETask(*vq_args, use_pallas=False, **BF16)
    vq_params = jax_vq.net.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4 * W)))["params"]
    np.savetxt(cb_path, np.asarray(vq_params["vector_quantizer"]["codebook"]), delimiter=",",
               header=",".join(map(str, range(DIM))), comments="")
    vq = VQVAETask(*vq_args, device="cpu", **BF16)
    vq.net.load_state_dict(vqvae_state_dict_from_jax(vq_params, 1))

    bert_args = (2e-4, str(tmp), str(cb_path), SR, 2, K_CODES)
    jax_bert = JaxAudioBertTask(*bert_args, **BF16)
    jax_bert.config = JaxBertConfig(**SMALL, **BF16)
    jax_bert.bert = JaxBertForMaskedLM(jax_bert.config)
    bert_params = jax_bert.init_variables(
        jax.random.PRNGKey(1), (jnp.zeros((1, W), jnp.int32), jnp.zeros((1, 4, 4 * W))))["params"]
    bert = AudioBertTask(*bert_args, device="cpu", config=BertConfig(**SMALL), **BF16)
    bert.net.load_state_dict(audio_bert_state_dict_from_jax(
        jax.tree.map(np.asarray, bert_params)))
    return dict(jax_sep=JaxSourceSeparator(jax_vq, vq_params, frame_samples=4 * W, batch_size=4),
                sep=SourceSeparator(vq, frame_samples=4 * W, batch_size=4),
                jax_gen=JaxAudioGenerator(jax_bert, bert_params, jax_vq, vq_params),
                gen=AudioGenerator(bert, vq))


def _close_in_scale(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= SCALE_TOL * np.abs(want).max()


def _song():
    return np.random.default_rng(0).standard_normal(9500).astype(np.float32)


@pytest.mark.parametrize("overlap", [False, True])
def test_bf16_separate_matches_jax(serving, overlap):
    _close_in_scale(serving["sep"].separate(_song(), overlap=overlap),
                    serving["jax_sep"].separate(_song(), overlap=overlap))


def test_bf16_encode_codes_match_jax(serving):
    got, want = serving["sep"].encode_codes(_song()), serving["jax_sep"].encode_codes(_song())
    assert got.shape == want.shape == (5, W)
    assert (got == want).mean() >= 0.95


def test_bf16_corrupt_and_generate_matches_jax(serving):
    stems = (0.3 * np.random.default_rng(0).standard_normal((2, 4, 4 * W))).astype(np.float32)
    _close_in_scale(serving["gen"].corrupt_and_generate(stems, 1, rng=np.random.default_rng(5)),
                    serving["jax_gen"].corrupt_and_generate(stems, 1,
                                                            rng=np.random.default_rng(5)))


def test_bf16_decode_and_sample_codes_match_jax(serving):
    codes = np.random.default_rng(2).integers(0, K_CODES, (2, W))
    _close_in_scale(serving["gen"].decode_codes(codes), serving["jax_gen"].decode_codes(codes))
    got = serving["gen"].sample_codes(W, batch=2, rounds=3, seed=3)
    want = serving["jax_gen"].sample_codes(W, batch=2, rounds=3, seed=3)
    assert got.shape == want.shape == (2, W) and (got == want).mean() >= 0.95
