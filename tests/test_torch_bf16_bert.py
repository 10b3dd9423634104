"""BERT and Audio-BERT with compute_dtype="bfloat16" on the CPU against the JAX
package's bf16 models on the same fp32 weights, at a small BERT (vocab 120,
hidden 32, 2 layers, 2 heads):

* ``BertForMaskedLM``: the bf16 MLM hidden states and the fp32 logits within
  0.02 of their scale (measured: 0.6 %; the two frameworks round the bf16
  stream after sums taken in other orders, a bf16 ulp being 2⁻⁸ of a value);
* ``AudioBertTask``'s vocab ids (``_chunked_argmax``, behind ``forward`` and
  ``code_proposals``) at W = 500 and 1,100: at least 95 % equal (measured
  99.8 % and 99.1 %) and every differing id a bf16 near-tie. The two hidden
  states part by a few bf16 ulps of each element (the stream is rounded after
  sums in other orders, through every layer), so with the port's pick a and
  JAX's b the fp64 logit gap on the port's h is held to 4 bf16 ulps of each
  term, 2⁻⁶·Σₖ |hₖ|·|e_a,k − e_b,k| (measured: at most 0.14 of that). Each
  confidence moves with the logits: |Δ log conf| ≤ 2·2⁻⁶·max_v Σₖ |hₖ|·|e_v,k|
  (the max and the logsumexp each move by at most the largest logit's move;
  measured at most 0.18 of it);
* ``predict_step``'s stems equal JAX's head (fp32, unchanged by the mode) on
  the port's own code ids at rtol = atol = 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msla_tpu.models.bert import AudioBertTask as JaxAudioBertTask
from msla_tpu.nn.bert import BertConfig as JaxBertConfig
from msla_tpu.nn.bert import BertForMaskedLM as JaxBertForMaskedLM
from msla_tpu_torch.models.bert import AudioBertTask
from msla_tpu_torch.nn.bert import BertConfig, BertForMaskedLM
from msla_tpu_torch.utils.jax_compat import (audio_bert_state_dict_from_jax,
                                             bert_state_dict_from_jax)

SMALL = dict(vocab_size=120, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
             intermediate_size=64)
BF16 = dict(compute_dtype="bfloat16")
K_CODES, DIM, FRAME_S = 16, 8, 2


def _ids_and_mask():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, SMALL["vocab_size"], (3, 20))
    mask = np.ones((3, 20), np.float32)
    mask[1, 12:] = 0.0
    mask[2, :] = 0.0  # a sequence of padding alone
    return ids, mask


@pytest.mark.parametrize("return_mlm_hidden", [False, True])
def test_bf16_bert_matches_jax(return_mlm_hidden):
    jax_net = JaxBertForMaskedLM(JaxBertConfig(**SMALL, max_position_embeddings=64, **BF16))
    params = jax_net.init(jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))["params"]
    params = {**params, "mlm_bias": jnp.asarray(
        np.random.default_rng(9).standard_normal(SMALL["vocab_size"]), jnp.float32)}
    net = BertForMaskedLM(BertConfig(**SMALL, max_position_embeddings=64, **BF16),
                          device="cpu")
    net.load_state_dict(bert_state_dict_from_jax(jax.tree.map(np.asarray, params)))
    ids, mask = _ids_and_mask()
    want = np.asarray(jax_net.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask),
                                    return_mlm_hidden=return_mlm_hidden)).astype(np.float32)
    with torch.no_grad():
        got = net(torch.from_numpy(ids), torch.from_numpy(mask),
                  return_mlm_hidden=return_mlm_hidden)
    assert got.dtype == (torch.bfloat16 if return_mlm_hidden else torch.float32)
    assert np.abs(got.float().numpy() - want).max() <= 0.02 * np.abs(want).max()


def make_pair(tmp_path, sr):
    """The JAX bf16 task and the port's on the same weights; W = sr·FRAME_S / 4."""
    cb_path = tmp_path / "codebook.csv"
    cb = np.random.default_rng(0).standard_normal((K_CODES, DIM)).astype(np.float32)
    np.savetxt(cb_path, cb, delimiter=",", header=",".join(map(str, range(DIM))), comments="")
    args = (2e-4, str(tmp_path / "ckpt"), str(cb_path), sr, FRAME_S, K_CODES)
    jax_task = JaxAudioBertTask(*args, **BF16)
    jax_task.config = JaxBertConfig(**SMALL, **BF16)
    jax_task.bert = JaxBertForMaskedLM(jax_task.config)
    w = sr * FRAME_S // 4
    batch = (jnp.zeros((1, w), jnp.int32), jnp.zeros((1, 4, sr * FRAME_S)))
    params = jax_task.init_variables(jax.random.PRNGKey(0), batch)["params"]
    params["bert"] = {**params["bert"], "mlm_bias": jnp.asarray(
        np.random.default_rng(7).standard_normal(SMALL["vocab_size"]), jnp.float32)}
    task = AudioBertTask(*args, device="cpu", config=BertConfig(**SMALL), **BF16)
    task.net.load_state_dict(audio_bert_state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return jax_task, params, task


def _port_hidden(task, x) -> np.ndarray:
    """The port's MLM hidden states, (B·W, hidden) fp64, as _chunked_argmax folds them."""
    tokens, attn, unfold = task._fold(x)
    with torch.no_grad():
        h = torch.stack([task.bert(t, a, return_mlm_hidden=True) for t, a in zip(tokens, attn)])
    cols = [unfold(h[..., i].float()) for i in range(h.shape[-1])]
    return torch.stack(cols, -1).reshape(-1, h.shape[-1]).double().numpy()


@pytest.mark.parametrize("sr", [1000, 2200])  # W = 500: one chunk; W = 1100: three
def test_bf16_vocab_ids_and_confidences_match_jax(tmp_path, sr):
    jax_task, params, task = make_pair(tmp_path, sr)
    x = np.random.default_rng(1).integers(0, K_CODES, (2, sr * FRAME_S // 4)).astype(np.int32)
    want_ids, want_conf = (np.asarray(a).reshape(-1) for a in jax_task._chunked_argmax(
        params["bert"], jnp.asarray(x), with_conf=True))
    with torch.no_grad():
        ids, conf = (a.numpy().reshape(-1) for a in task._chunked_argmax(
            torch.from_numpy(x).long(), with_conf=True))
    assert (ids == want_ids).mean() >= 0.95
    h = _port_hidden(task, torch.from_numpy(x).long())
    emb, bias = (w.detach().double().numpy() for w in task._decoder_weights())  # bf16 E
    rows = np.flatnonzero(ids != want_ids)
    a, b = ids[rows], want_ids[rows]
    gap = (h[rows] * (emb[a] - emb[b])).sum(1) + bias[a] - bias[b]
    assert (gap <= 2.0 ** -6 * (np.abs(h[rows]) * np.abs(emb[a] - emb[b])).sum(1)).all()
    moved = 2.0 ** -6 * (np.abs(h) @ np.abs(emb).T).max(1)
    assert (np.abs(np.log(conf) - np.log(want_conf)) <= 2 * moved).all()


def test_bf16_predict_step_is_jax_head_on_the_ports_codes(tmp_path):
    jax_task, params, task = make_pair(tmp_path, 2200)
    x = np.random.default_rng(2).integers(0, K_CODES, (2, 1100)).astype(np.int32)
    got = task.predict_step((torch.from_numpy(x), None))
    with torch.no_grad():
        code_ids = task._code_ids(task._chunked_argmax(torch.from_numpy(x).long(),
                                                       with_conf=False)).numpy()
    quantized = np.asarray(params["codebook"])[code_ids].reshape(2, 1100, DIM)
    want = np.asarray(jax_task.head.apply({"params": params["head"]},
                                          jnp.asarray(quantized.transpose(0, 2, 1))))
    assert got.dtype == torch.float32 and got.shape == (2, 4, 2200 * FRAME_S)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
