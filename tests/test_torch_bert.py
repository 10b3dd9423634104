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
    # dropout runs now (test_dropout_is_the_jax_hidden_dropout)
    net = BertForMaskedLM(BertConfig(**SMALL), device="cpu")
    ids = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="torch.Generator"):
        net(ids, deterministic=False)
    assert torch.isfinite(net(ids, deterministic=False,
                              generator=torch.Generator().manual_seed(0))).all()


def test_dropout_is_the_jax_hidden_dropout(pair, monkeypatch):
    """deterministic=True is unchanged (JAX's forward); with it False the
    JAX module's three hidden dropouts a layer (msla_tpu/nn/bert.py:66, 76,
    84: embeddings, attention branch, FFN branch) draw from the generator:
    the same seed gives the same masks, another seed others, the kept share
    is 1 − p within 5 binomial σ and the kept values are scaled by 1/(1 − p);
    attention keeps the flash path."""
    from msla_tpu_torch.nn import bert as port_bert
    from msla_tpu_torch.nn.layers import dropout

    jax_net, params, net = pair
    ids, am = _inputs()
    want = np.asarray(jax_net.apply({"params": params}, jnp.asarray(ids), jnp.asarray(am)))
    got = net(torch.from_numpy(ids), torch.from_numpy(am), deterministic=True)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)

    calls = []

    def record(a, rate, generator, deterministic=True):
        out = dropout(a, rate, generator, deterministic)
        calls.append((a.detach(), out.detach()))
        return out

    monkeypatch.setattr(port_bert, "dropout", record)
    p = SMALL.get("hidden_dropout_prob", 0.1)
    runs = []
    for seed in (1, 1, 2):
        calls.clear()
        net(torch.from_numpy(ids), torch.from_numpy(am), deterministic=False,
            generator=torch.Generator().manual_seed(seed))
        runs.append(list(calls))
    assert len(runs[0]) == 1 + 2 * SMALL["num_hidden_layers"]
    kept_n = live_n = 0
    for (a, out), (a2, out2), (_, out3) in zip(*runs):
        assert torch.equal(out, out2) and not torch.equal(out != 0, out3 != 0)
        kept = out != 0
        assert torch.equal(out[kept], a[kept] / (1 - p)) and not out[~kept].any()
        kept_n, live_n = kept_n + kept.sum().item(), live_n + (a != 0).sum().item()
    sigma = (p * (1 - p) / live_n) ** 0.5
    assert abs(kept_n / live_n - (1 - p)) < 5 * sigma
