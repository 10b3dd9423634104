"""The transformer stage in the port on the CPU against the JAX package, at a
small size: 2 layers, 4 heads, hidden 32, S = 8 latent channels, T = 128
(W = 32), on the same weights through ``transformer_state_dict_from_jax``.

* Positional encoding, both modes: bit-equal; ``causal_mask`` bit-equal.
* Masked attention with ``causal_mask``, with and without ``kv_mask``, fp32:
  within 1e-5.
* ``DecoderLayer`` (``zero_memory`` both ways) and
  ``TransformerQuantizerNet`` forwards in fp32: within 1e-5; in bf16: within
  2 × the JAX package's own bf16-vs-fp32 distance.
* ``TransformerTask``: ``loss_fn`` and ``eval_metrics`` within 1e-6 (SI-SDR
  at rtol 1e-5), with and without experts; 3 ``Trainer.fit`` steps at
  ``dropout=0`` over a small VQ-VAE teacher against the JAX Trainer:
  metrics within 1e-3, parameter moves within 0.2·lr where the first
  gradient is clear of 0 (above 1e-2 of the tensor's largest); the ``best_transformer.ckpt`` the JAX Trainer
  wrote, read by ``load_checkpoint``, gives the same forward.
* Dropout at each site (attention, FFN, residual, MoE): one generator seed
  gives the same mask twice, another seed another; the kept share is 1 − p
  within 5 binomial σ; kept values are the input scaled by 1/(1 − p).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msla_tpu.data.datamodule import SlakhDataModule as JaxSlakhDataModule
from msla_tpu.data.transform import Quantize as JaxQuantize
from msla_tpu.models.transformer import TransformerTask as JaxTransformerTask
from msla_tpu.models.vqvae import VQVAETask as JaxVQVAETask
from msla_tpu.nn.attention import MultiHeadAttention as JaxMHA
from msla_tpu.nn.attention import causal_mask as jax_causal_mask
from msla_tpu.nn.positional import PositionalEncoding as JaxPositionalEncoding
from msla_tpu.nn.transformer_net import DecoderLayer as JaxDecoderLayer
from msla_tpu.nn.transformer_net import TransformerQuantizerNet as JaxNet
from msla_tpu.train.callbacks import ModelCheckpoint as JaxModelCheckpoint
from msla_tpu.train.trainer import Trainer as JaxTrainer
from msla_tpu_torch.data.datamodule import SlakhDataModule
from msla_tpu_torch.data.transform import Quantize
from msla_tpu_torch.models.transformer import TransformerTask
from msla_tpu_torch.models.vqvae import VQVAETask
from msla_tpu_torch.nn import attention as port_attention
from msla_tpu_torch.nn import moe as port_moe
from msla_tpu_torch.nn import transformer_net as port_net
from msla_tpu_torch.nn.attention import MultiHeadAttention, causal_mask
from msla_tpu_torch.nn.layers import dropout
from msla_tpu_torch.nn.positional import PositionalEncoding
from msla_tpu_torch.nn.transformer_net import DecoderLayer, TransformerQuantizerNet
from msla_tpu_torch.train.checkpoint import load_checkpoint, weights_of
from msla_tpu_torch.train.trainer import Trainer
from msla_tpu_torch.utils.jax_compat import (transformer_state_dict_from_jax,
                                             vqvae_state_dict_from_jax)

LAYERS, HEADS, HIDDEN, S, SR, FRAME_S = 2, 4, 32, 8, 64, 2
T = SR * FRAME_S          # 128
W = T // 4                # 32
B = 3
TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-6, atol=1e-6)
SDR_TOL = dict(rtol=1e-5, atol=1e-5)
LR = 1e-3
NET = dict(input_dim=W, output_dim=T, hidden_dim=HIDDEN, num_layers=LAYERS, num_heads=HEADS)


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _mha_state(params):
    """flax MultiHeadAttention params → the port's state_dict."""
    return {f"{proj}.{name}": torch.from_numpy(np.array(
        params[proj]["kernel"]).T.copy() if name == "weight" else np.array(params[proj]["bias"]))
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj") for name in ("weight", "bias")}


def _layer_state(params):
    """One flax DecoderLayer's params as the port's DecoderLayer state_dict."""
    stub = {"kernel": np.zeros((1, 1), np.float32), "bias": np.zeros(1, np.float32)}
    sd = transformer_state_dict_from_jax({"embedding": stub, "fc": stub, "layer0": params}, 1)
    return {k[len("layer0."):]: v for k, v in sd.items() if k.startswith("layer0.")}


@pytest.mark.parametrize("mode", ["reference", "standard"])
def test_positional_encoding_bit_equal(mode):
    x = _np(0, 5, 7, HIDDEN)
    want = np.asarray(JaxPositionalEncoding(HIDDEN, mode=mode).apply({}, jnp.asarray(x)))
    got = PositionalEncoding(HIDDEN, mode=mode, device="cpu")(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not PositionalEncoding(HIDDEN, device="cpu").state_dict()  # built, not learned
    with pytest.raises(ValueError, match="table of 4"):
        PositionalEncoding(HIDDEN, max_len=4, mode=mode, device="cpu")(torch.zeros(5, 5, HIDDEN))


def test_causal_mask_bit_equal():
    np.testing.assert_array_equal(causal_mask(6).numpy(), np.asarray(jax_causal_mask(6)))


@pytest.mark.parametrize("with_kv_mask", [False, True])
def test_masked_attention_matches_jax(with_kv_mask):
    x = _np(1, B, S, HIDDEN)
    kv = np.ones((B, S), np.float32)
    kv[1, S - 3:] = 0.0
    jax_mha = JaxMHA(HIDDEN, HEADS)
    params = jax_mha.init(jax.random.PRNGKey(0), *[jnp.asarray(x)] * 3)["params"]
    want = np.asarray(jax_mha.apply({"params": params}, *[jnp.asarray(x)] * 3,
                                    mask=jax_causal_mask(S),
                                    kv_mask=jnp.asarray(kv) if with_kv_mask else None))
    mha = MultiHeadAttention(HIDDEN, HEADS, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    mha.load_state_dict(_mha_state(params))
    xt = torch.from_numpy(x)
    got = mha(xt, xt, xt, mask=causal_mask(S),
              kv_mask=torch.from_numpy(kv) if with_kv_mask else None)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def _bf16_within_twice_jax(name, got16, jax16, jax32):
    """The port's bf16 output within 2 × JAX's own bf16-vs-fp32 distance of
    JAX's bf16 output."""
    own = np.abs(np.asarray(jax16, np.float32) - np.asarray(jax32, np.float32)).max()
    err = np.abs(got16.detach().float().numpy() - np.asarray(jax16, np.float32)).max()
    assert 0 < own and err <= 2 * own, (name, err, own)


@pytest.mark.parametrize("zero_memory", [True, False])
def test_decoder_layer_matches_jax(zero_memory):
    x, memory = _np(2, B, S, HIDDEN), _np(3, B, 5, HIDDEN)
    mask = jax_causal_mask(S)
    outs = {}
    for dtype in (None, "bfloat16"):
        layer = JaxDecoderLayer(HIDDEN, HEADS, dim_feedforward=64, dropout=0.0,
                                zero_memory=zero_memory, dtype=dtype)
        params = layer.init(jax.random.PRNGKey(4), jnp.asarray(x), jnp.asarray(memory),
                            mask)["params"]
        want = layer.apply({"params": params}, jnp.asarray(x), jnp.asarray(memory), mask)
        port = DecoderLayer(HIDDEN, HEADS, dim_feedforward=64, dropout=0.0,
                            zero_memory=zero_memory,
                            dtype=None if dtype is None else torch.bfloat16,
                            generator=torch.Generator().manual_seed(0), device="cpu")
        port.load_state_dict(_layer_state(params))
        got, aux = port(torch.from_numpy(x), torch.from_numpy(memory), causal_mask(S))
        assert aux is None and got.dtype == torch.float32
        outs[dtype] = (got, want)
    np.testing.assert_allclose(outs[None][0].detach().numpy(), np.asarray(outs[None][1]), **TOL)
    _bf16_within_twice_jax("DecoderLayer", outs["bfloat16"][0], outs["bfloat16"][1],
                           outs[None][1])


def _jax_params(net, quantized, seed=5):
    return jax.device_get(net.init(jax.random.PRNGKey(seed), jnp.asarray(quantized))["params"])


def test_network_matches_jax_fp32_and_bf16():
    quantized = _np(6, B, S, W)
    jax32 = JaxNet(**NET, dropout=0.0)
    params = _jax_params(jax32, quantized)
    want32 = np.asarray(jax32.apply({"params": params}, jnp.asarray(quantized)))
    want16 = np.asarray(JaxNet(**NET, dropout=0.0, compute_dtype="bfloat16").apply(
        {"params": params}, jnp.asarray(quantized)))
    state = transformer_state_dict_from_jax(params, LAYERS)
    for dtype, want in ((None, want32), ("bfloat16", want16)):
        net = TransformerQuantizerNet(**NET, dropout=0.0, compute_dtype=dtype, latent_channels=S,
                                      device="cpu")
        net.load_state_dict(state)
        got = net(torch.from_numpy(quantized))
        assert got.shape == (B, 4, T) and got.dtype == torch.float32
        if dtype is None:
            np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
        else:
            _bf16_within_twice_jax("TransformerQuantizerNet", got, want, want32)
    assert sorted(state) == sorted(net.state_dict())


# ---- the task ----------------------------------------------------------------------------

VQ = dict(num_hidden=16, num_residual_layer=2, num_residual_hidden=8, num_embedding=16,
          embedding_dim=S, commitment_cost=0.25, learning_rate=1e-4)
DM_ARGS = dict(train_dir="t", val_dir="v", test_dir="s", target_sample_rate=SR,
               target_sample_duration=FRAME_S, max_duration=120, maximum_dataset_size=100,
               batch_size=B)
TRAIN = [_np(10 + i, B, 4, T, scale=0.3) for i in range(3)]
VAL = [_np(20 + i, B, 4, T, scale=0.3) for i in range(2)]


def _in_memory(cls):
    class InMemory(cls):
        def __init__(self, **kw):
            super().__init__(**DM_ARGS, quantized_latents=True, **kw)

        def train_dataloader(self):
            return list(TRAIN)

        def val_dataloader(self):
            return list(VAL)

        test_dataloader = val_dataloader

    return InMemory


JaxDM, PortDM = _in_memory(JaxSlakhDataModule), _in_memory(SlakhDataModule)
TASK = dict(sample_rate=SR, frame_length=FRAME_S, learning_rate=LR, num_layers=LAYERS,
            num_heads=HEADS, hidden_dim=HIDDEN, dropout=0.0)


@pytest.fixture(scope="module")
def teacher(tmp_path_factory):
    """A small JAX VQ-VAE teacher (D = S = 8, W = 32) and its port."""
    root = tmp_path_factory.mktemp("transformer")
    paths = dict(checkpoint_dir=str(root), codebook_file=str(root / "codebook.csv"))
    jax_vq = JaxVQVAETask(**VQ, sample_rate=SR, **paths)
    mix = np.broadcast_to(TRAIN[0].sum(1, keepdims=True), TRAIN[0].shape)
    params = jax.device_get(jax_vq.init_variables(
        jax.random.PRNGKey(3), (jnp.asarray(mix), jnp.asarray(TRAIN[0])))["params"])
    port_vq = VQVAETask(**VQ, sample_rate=SR, **paths, device="cpu")
    port_vq.net.load_state_dict(vqvae_state_dict_from_jax(params, VQ["num_residual_layer"]))
    return dict(root=root, jax=JaxQuantize(jax_vq.net, {"params": params}),
                port=Quantize(port_vq))


def _tasks(teacher, **kw):
    jax_task = JaxTransformerTask(**TASK, checkpoint_dir=str(teacher["root"]), **kw)
    latents = teacher["jax"].get_quantized(jnp.asarray(TRAIN[0]))
    params = jax.device_get(jax_task.init_variables(
        jax.random.PRNGKey(0), (latents, jnp.asarray(TRAIN[0])))["params"])
    task = TransformerTask(**TASK, checkpoint_dir=str(teacher["root"]), latent_channels=S,
                           device="cpu", **kw)
    task.net.load_state_dict(task.state_dict_from_jax(params))
    return jax_task, params, task


def _batch(teacher, raw):
    jax_batch = (teacher["jax"].get_quantized(jnp.asarray(raw)), jnp.asarray(raw))
    return jax_batch, (torch.from_numpy(np.array(jax_batch[0])), torch.from_numpy(raw))


@pytest.mark.parametrize("experts", [0, 4])
def test_loss_and_metrics_match_jax(teacher, experts):
    jax_task, params, task = _tasks(teacher, moe_experts=experts)
    jax_batch, batch = _batch(teacher, TRAIN[1])
    want_loss, want = jax_task.loss_fn(params, jax_batch, jax.random.PRNGKey(1))
    loss, got = task.loss_fn(batch, None)
    np.testing.assert_allclose(loss.item(), float(want_loss), **LOSS_TOL)
    assert set(got) == set(want) == {"train/loss"} | ({"train/moe_aux"} if experts else set())
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), err_msg=k, **LOSS_TOL)

    jax_batch, batch = _batch(teacher, VAL[0])
    want = jax_task.eval_metrics(params, jax_batch, "testing")
    with torch.no_grad():
        got = task.eval_metrics(batch, task.test_mode_name)
    assert set(got) == set(want) and len(got) == 16
    for k in want:
        tol = SDR_TOL if "si_sdr" in k else LOSS_TOL
        np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=k, **tol)
    opt = task.configure_optimizer()
    assert type(opt) is torch.optim.Adam and opt.defaults["betas"] == (0.9, 0.999)
    assert opt.defaults["eps"] == 1e-8 and opt.defaults["lr"] == LR


def test_three_fit_steps_match_the_jax_trainer(teacher, tmp_path):
    jax_task, params, task = _tasks(teacher)
    ckpt_dir = tmp_path / "jax_ckpt"
    jax_trainer = JaxTrainer(default_root_dir=str(tmp_path), max_epochs=1, accelerator="cpu",
                             enable_progress_bar=False, log_every_n_steps=0, seed=0,
                             callbacks=[JaxModelCheckpoint(str(ckpt_dir),
                                                           filename="best_transformer")])
    jax_trainer.fit(jax_task, JaxDM(quantizer=teacher["jax"]))
    end = jax.device_get(jax_trainer.state.params)

    start = {k: v.clone() for k, v in task.net.state_dict().items()}
    trainer = Trainer(max_epochs=1, accelerator="cpu", enable_progress_bar=False,
                      log_every_n_steps=0, seed=0)
    trainer.fit(task, PortDM(quantizer=teacher["port"]))
    assert trainer.global_step == jax_trainer.global_step == 3

    want = jax_trainer.callback_metrics
    assert set(trainer.callback_metrics) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(trainer.callback_metrics[k], v, rtol=1e-3, err_msg=k)

    grads = task.state_dict_from_jax(jax.device_get(jax.grad(
        lambda p: jax_task.loss_fn(p, _batch(teacher, TRAIN[0])[0],
                                   jax.random.PRNGKey(0))[0])(params)))
    want_sd = task.state_dict_from_jax(end)
    for key, value in task.net.state_dict().items():
        # clear of 0: above 1e-2 of the largest. The 2,048 ReLU units make
        # small gradients common, and an element at 2e-3 of the largest was
        # seen to take one of its 3 Adam steps (±lr) the other way
        g = grads[key].abs()
        sure = g > 1e-2 * g.max()
        moved, want_moved = value - start[key], want_sd[key] - start[key]
        assert sure.any(), key
        np.testing.assert_allclose(moved[sure].numpy(), want_moved[sure].numpy(),
                                   atol=0.2 * LR, err_msg=key)

    # the JAX Trainer's best_transformer.ckpt, read by the port: the same forward
    payload = load_checkpoint(ckpt_dir / "best_transformer.ckpt")
    loaded = TransformerTask(**TASK, checkpoint_dir=str(tmp_path), latent_channels=S,
                             device="cpu")
    loaded.net.load_state_dict(weights_of(loaded, payload))
    jax_batch, batch = _batch(teacher, VAL[1])
    want_out = np.asarray(jax_task.predict_step(end, jax_batch))
    np.testing.assert_allclose(loaded.predict_step(batch).numpy(), want_out, **TOL)


# ---- dropout -----------------------------------------------------------------------------

P = 0.25


def test_dropout_keeps_1_minus_p_and_scales_the_kept():
    x = torch.full((200_000,), 3.0)
    draws = [dropout(x, P, torch.Generator().manual_seed(s), deterministic=False)
             for s in (1, 1, 2)]
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
    kept = draws[0] != 0
    sigma = (P * (1 - P) / x.numel()) ** 0.5
    assert abs(kept.double().mean().item() - (1 - P)) < 5 * sigma
    assert torch.equal(draws[0][kept], x[kept] / (1 - P))
    assert dropout(x, P, None) is x  # deterministic
    with pytest.raises(ValueError, match="torch.Generator"):
        dropout(x, P, None, deterministic=False)


def _recorded(monkeypatch):
    """Every dropout call of the attention, the decoder layers and the MoE
    experts, as (site, input, output)."""
    calls = []
    for module, site in ((port_attention, "attention"), (port_net, "layer"),
                         (port_moe, "moe")):
        def record(a, rate, generator, deterministic=True, _site=site):
            out = dropout(a, rate, generator, deterministic)
            calls.append((_site, a.detach().clone(), out.detach().clone()))
            return out
        monkeypatch.setattr(module, "drop", record)
    return calls


@pytest.mark.parametrize("site", ["attention", "ffn", "residual", "moe"])
def test_dropout_at_each_site(site, monkeypatch):
    """A dense layer calls the layer's dropout 4 times (self-attention,
    cross-attention, FFN inner, FFN residual); with experts 3 (no FFN inner)
    and the experts' own once."""
    experts = 4 if site == "moe" else 0
    net = TransformerQuantizerNet(**NET, dropout=P, moe_experts=experts, latent_channels=S,
                                  device="cpu")
    x = torch.from_numpy(_np(7, 16, S, W))
    calls = _recorded(monkeypatch)
    runs = {}
    for seed in (3, 3, 4):
        calls.clear()
        net(x, deterministic=False, generator=torch.Generator().manual_seed(seed))
        layer = [c for c in calls if c[0] == "layer"]
        pick = {"attention": [c for c in calls if c[0] == "attention"],
                "moe": [c for c in calls if c[0] == "moe"],
                "ffn": layer[2::4],
                "residual": [c for i, c in enumerate(layer) if i % 4 != 2]}[site]
        assert len(pick) == {"attention": LAYERS, "moe": LAYERS, "ffn": LAYERS,
                             "residual": 3 * LAYERS}[site]
        runs.setdefault(seed, []).append(pick)
    (first, again), (other,) = runs[3], runs[4]
    for (_, a, out), (_, a2, out2), (_, _, out3) in zip(first, again, other):
        assert torch.equal(a, a2) and torch.equal(out, out2)      # one seed, one mask
        live = a != 0                                             # ReLU zeros, masked keys
        assert not torch.equal(out != 0, out3 != 0)               # another seed, another
        kept = (out != 0) & live
        share = kept.sum().item() / live.sum().item()
        sigma = (P * (1 - P) / live.sum().item()) ** 0.5
        assert abs(share - (1 - P)) < 5 * sigma, share
        assert torch.equal(out[kept], a[kept] / (1 - P))
        assert not out[~kept & live].any()
    with torch.no_grad():
        calls.clear()
        quiet = net(x)  # deterministic: no mask drawn
    assert all(torch.equal(a, out) for _, a, out in calls)
    assert torch.isfinite(quiet).all()
