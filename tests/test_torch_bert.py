"""msla_tpu_torch.nn.bert on the CPU against the JAX package's BertForMaskedLM
at a small config (vocab 120, hidden 32, 2 layers, 2 heads) on the same
weights (``bert_state_dict_from_jax``), with a padding mask: logits and the
MLM hidden states at rtol 1e-4, atol 1e-5 (fp32 LayerNorms, where flax takes
the variance as E[x²] − E[x]² and torch by Welford, and sums in another
order, over two layers)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msla_tpu.nn.bert import BertConfig as JaxBertConfig
from msla_tpu.nn.bert import BertForMaskedLM as JaxBertForMaskedLM
from msla_tpu_torch.nn.bert import BertConfig, BertForMaskedLM
from msla_tpu_torch.utils.jax_compat import bert_state_dict_from_jax

SMALL = dict(vocab_size=120, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
             intermediate_size=64, max_position_embeddings=64)
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    jax_net = JaxBertForMaskedLM(JaxBertConfig(**SMALL))
    params = jax_net.init(jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))["params"]
    # a non-zero vocab bias, so the logits test sees it
    params = {**params, "mlm_bias": jnp.asarray(
        np.random.default_rng(9).standard_normal(SMALL["vocab_size"]), jnp.float32)}
    net = BertForMaskedLM(BertConfig(**SMALL), device="cpu")
    net.load_state_dict(bert_state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return jax_net, params, net


def _inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, SMALL["vocab_size"], (3, 20))
    mask = np.ones((3, 20), np.float32)
    mask[1, 12:] = 0.0
    mask[2, :] = 0.0  # a sequence of padding alone
    return ids, mask


@pytest.mark.parametrize("return_mlm_hidden", [False, True])
def test_matches_jax(pair, return_mlm_hidden):
    jax_net, params, net = pair
    ids, mask = _inputs()
    want = np.asarray(jax_net.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask),
                                    return_mlm_hidden=return_mlm_hidden))
    with torch.no_grad():
        got = net(torch.from_numpy(ids), torch.from_numpy(mask),
                  return_mlm_hidden=return_mlm_hidden)
    width = SMALL["hidden_size"] if return_mlm_hidden else SMALL["vocab_size"]
    assert got.shape == (3, 20, width)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_no_mask_means_attend_everything(pair):
    _, _, net = pair
    ids, _ = _inputs()
    ids = torch.from_numpy(ids)
    with torch.no_grad():
        torch.testing.assert_close(net(ids), net(ids, torch.ones(ids.shape)), rtol=0, atol=0)


def test_state_dict_keys_are_hf_bert_for_masked_lm():
    """The keys of HF's BertForMaskedLM, the tied decoder's included, so an
    HF state_dict loads strictly; decoder weight and bias are shared."""
    transformers = pytest.importorskip("transformers")
    hf = transformers.BertForMaskedLM(transformers.BertConfig(**SMALL))
    net = BertForMaskedLM(BertConfig(**SMALL), device="cpu")
    assert list(net.state_dict()) == list(hf.state_dict())
    net.load_state_dict(hf.state_dict())
    pred = net.cls.predictions
    assert pred.decoder.weight is net.bert.embeddings.word_embeddings.weight
    assert pred.decoder.bias is pred.bias


def test_init_families():
    """Embeddings: flax's truncated normal, std 1/√hidden, cut at 2σ/0.88;
    dense layers U(±1/√fan_in); norms 1 and 0; vocab bias 0."""
    net = BertForMaskedLM(BertConfig(), device="cpu", seed=1)
    word = net.bert.embeddings.word_embeddings.weight
    assert abs(word.std().item() - 768 ** -0.5) < 1e-3
    assert word.abs().max().item() <= 2 * 768 ** -0.5 / 0.87962566103423978 + 1e-6
    inter = net.bert.encoder.layer[0].intermediate.dense
    assert inter.weight.abs().max().item() <= 768 ** -0.5
    assert inter.weight.abs().max().item() > 0.99 * 768 ** -0.5
    out = net.bert.encoder.layer[0].output
    assert out.dense.bias.abs().max().item() <= 3072 ** -0.5
    assert torch.equal(out.LayerNorm.weight, torch.ones(768))
    assert not net.cls.predictions.bias.any()


def test_waiting_options_raise():
    """bf16 runs now (tests/test_torch_bf16_bert.py holds it against JAX)."""
    bf16 = BertForMaskedLM(BertConfig(**SMALL, compute_dtype="bfloat16"), device="cpu")
    assert bf16(torch.zeros((1, 4), dtype=torch.int64), return_mlm_hidden=True).dtype == \
        torch.bfloat16
    with pytest.raises(NotImplementedError, match="ROADMAP.md §3"):
        BertForMaskedLM(BertConfig(**SMALL, use_flash=False), device="cpu")
    net = BertForMaskedLM(BertConfig(**SMALL), device="cpu")
    with pytest.raises(NotImplementedError, match="queue item 5"):
        net(torch.zeros((1, 4), dtype=torch.int64), deterministic=False)
