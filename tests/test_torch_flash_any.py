"""#7 at any head width D from 1 to 256, Sq and Sk free, forward and backward,
on the CPU against the JAX package.

* the plain forward (``attention_ref``, and ``flash_attn`` on CPU tensors)
  against ``_xla_attention`` on every row, at D = 1 to 256 and (Sq, Sk) =
  (40, 40), (17, 67), (1, 50), with and without a mask (a row with padded
  keys, a row of padding alone): atol = rtol = 1e-5, the tolerance table's
  "Transformer attention";
* the backward: ``attention_bwd_ref`` (FA2's recompute from the saved
  log-sum-exp) and autograd through ``flash_attn`` (``_FlashAttn``, whose CPU
  backward runs it) against ``jax.vjp(_xla_attention)`` on every row, the
  row of padding alone included (a uniform softmax's gradient): 1e-5;
* the backward against JAX's Pallas TPU kernels (``_flash`` under
  ``jax.grad``, ``_flash_attention_bwd_dkv`` and ``_bwd_dq``) in interpret
  mode, at D = 26 and 96, S = 128, on a loss over the real query rows (the
  TPU kernel masks padded query rows by segment ids): fp32 within 1e-5, bf16
  within 2 × JAX's own bf16-vs-fp32 distance;
* chip_smoke.py's fp64 bounds for the fp32 kernels, the forward's at any D
  and Sk and the backward's: they hold the plain versions and the 3xTF32
  emulations and reject single-pass TF32;
* a ``DecoderLayer(zero_memory=False)`` at head width 26 over a memory of
  another length with a zero tail: the output and every parameter's gradient
  (the cross-attention's projections included) against ``jax.grad`` of the
  JAX layer, within 1e-5 of each tensor's largest; a small BERT at head
  width 26 with a padding mask against the JAX BERT;
* ``plan_attention`` over every D from 1 to 257 in both types.
"""
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from msla_tpu.nn.bert import BertConfig as JaxBertConfig
from msla_tpu.nn.bert import BertForMaskedLM as JaxBertForMaskedLM
from msla_tpu.nn.attention import causal_mask as jax_causal_mask
from msla_tpu.nn.transformer_net import DecoderLayer as JaxDecoderLayer
from msla_tpu.ops.flash_attn import _flash, _xla_attention
from msla_tpu.ops.flash_attn import scaled_attention as jax_scaled_attention
from msla_tpu_torch.nn.attention import causal_mask
from msla_tpu_torch.nn.bert import BertConfig, BertForMaskedLM
from msla_tpu_torch.nn.transformer_net import DecoderLayer
from msla_tpu_torch.ops._build import CSRC, SIGNATURES, SMEM_BYTES, launch_count
from msla_tpu_torch.ops.flash_attn import (GRANULE, MAX_D, TUNED_D, _bwd, attention_3xtf32_ref,
                                           attention_bwd_3xtf32_ref, attention_bwd_ref,
                                           attention_lse_ref, attention_ref, flash_attn,
                                           plan_attention, scaled_attention)
from msla_tpu_torch.ops.tf32 import tf32_round_ref
from msla_tpu_torch.utils.jax_compat import (bert_state_dict_from_jax,
                                             transformer_state_dict_from_jax)

TOL = dict(rtol=1e-5, atol=1e-5)
WIDTHS = (1, 8, 26, 48, 96, 160, 256)
LENGTHS = ((40, 40), (17, 67), (1, 50))
B, H = 3, 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the whole run's workers share the host's cores,
    and torch's threads, each worker's as many as the cores, contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(d, s_q, s_k, masked, seed):
    """(B, H, Sq, D) q and d_out, (B, H, Sk, D) k, v, and a mask: row 0
    attends everything, row 1 its first two thirds, row 2 nothing."""
    rng = np.random.default_rng(seed)
    q, d_out = (rng.standard_normal((B, H, s_q, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, H, s_k, d)).astype(np.float32) for _ in range(2))
    mask = None
    if masked:
        mask = np.ones((B, s_k), np.float32)
        mask[1, 2 * s_k // 3:] = 0.0
        mask[2] = 0.0
    return q, k, v, mask, d_out


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _bshd(a):
    return a.transpose(1, 2).contiguous()


@pytest.mark.parametrize("d", WIDTHS)
def test_forward_matches_xla_chain_on_every_row(d):
    for n, (s_q, s_k) in enumerate(LENGTHS):
        for masked in (False, True):
            q, k, v, mask, _ = _inputs(d, s_q, s_k, masked, 10 * d + n)
            want = np.asarray(_xla_attention(*map(_j, (q, k, v, mask)), d ** -0.5))
            got = attention_ref(*map(_t, (q, k, v, mask)), d ** -0.5)
            np.testing.assert_allclose(got.numpy(), want, **TOL)
            on_cpu = flash_attn(*(_bshd(_t(a)) for a in (q, k, v)), _t(mask), d ** -0.5)
            assert on_cpu.shape == (B, s_q, H, d) and on_cpu.dtype == torch.float32
            np.testing.assert_allclose(on_cpu.transpose(1, 2).numpy(), want, **TOL)


@pytest.mark.parametrize("d", WIDTHS)
def test_backward_matches_jax_vjp_on_every_row(d):
    """FA2's formulas from the saved lse, and the autograd Function over them,
    against jax.vjp of the XLA chain; the row of padding alone keeps log Sk
    in its lse (``attention_shift``), so its softmax's gradient is the
    uniform one."""
    for n, (s_q, s_k) in enumerate(LENGTHS):
        for masked in (False, True):
            q, k, v, mask, d_out = _inputs(d, s_q, s_k, masked, 100 * d + n)
            scale = d ** -0.5
            _, vjp = jax.vjp(lambda a, b, c: _xla_attention(a, b, c, _j(mask), scale),
                             *map(_j, (q, k, v)))
            want = [np.asarray(g) for g in vjp(jnp.asarray(d_out))]
            tq, tk, tv, tm, tdo = map(_t, (q, k, v, mask, d_out))
            out = attention_ref(tq, tk, tv, tm, scale)
            lse = attention_lse_ref(tq, tk, tm, scale)
            plain = attention_bwd_ref(tq, tk, tv, tm, scale, out, lse, tdo)
            bq, bk, bv = (_bshd(t).requires_grad_() for t in (tq, tk, tv))
            flash_attn(bq, bk, bv, tm, scale).backward(_bshd(tdo))
            auto = [t.grad.transpose(1, 2) for t in (bq, bk, bv)]
            for got_plain, got_auto, w in zip(plain, auto, want):
                np.testing.assert_allclose(got_plain.numpy(), w, **TOL)
                np.testing.assert_allclose(got_auto.numpy(), w, **TOL)
            if masked:   # the uniform softmax: P = 1 / Sk on every key of row 2
                assert torch.allclose(lse[2], torch.full_like(lse[2], float(np.log(s_k))))


def _pallas_grads(q, k, v, mask, w, real, dtype):
    """dq, dk, dv of Σ (out ∘ w) over the first ``real`` query rows, through
    _flash (the Pallas TPU kernels, forward and backward) in interpret mode."""
    def loss(a, b, c):
        out = _flash(a, b, c, jnp.asarray(mask), q.shape[-1] ** -0.5)
        return (out[:, :, :real] * w[:, :, :real]).sum()

    with pltpu.force_tpu_interpret_mode():
        grads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a, dtype) for a in (q, k, v)))
    return [np.asarray(g, np.float32) for g in grads]


@pytest.mark.parametrize("d", [26, 96])
def test_backward_matches_pallas_kernels_on_real_rows(d):
    """B 1, H 2, S 128 (the Pallas path needs S % 128 = 0), 100 real rows and
    keys. fp32 within 1e-5; bf16 (JAX's TPU rounding points: dO, P and dS in
    bf16) within 2 × JAX's own bf16-vs-fp32 distance."""
    s, real = 128, 100
    rng = np.random.default_rng(d)
    q, k, v, w = (rng.standard_normal((1, H, s, d)).astype(np.float32) for _ in range(4))
    mask = np.ones((1, s), np.float32)
    mask[:, real:] = 0.0
    jax32 = _pallas_grads(q, k, v, mask, w, real, jnp.float32)
    jax16 = _pallas_grads(q, k, v, mask, w, real, jnp.bfloat16)
    for dtype in (torch.float32, torch.bfloat16):
        tq, tk, tv = (_bshd(torch.from_numpy(a)).to(dtype).requires_grad_() for a in (q, k, v))
        out = flash_attn(tq, tk, tv, torch.from_numpy(mask), d ** -0.5).transpose(1, 2)
        (out[:, :, :real] * torch.from_numpy(w)[:, :, :real]).sum().backward()
        got = [t.grad.transpose(1, 2).float().numpy() for t in (tq, tk, tv)]
        assert all(t.grad.dtype == dtype for t in (tq, tk, tv))
        for name, g, w32, w16 in zip("qkv", got, jax32, jax16):
            if dtype == torch.float32:
                np.testing.assert_allclose(g, w32, **TOL, err_msg=f"d{name}")
            else:
                own = np.abs(w16 - w32).max()
                assert 0 < own and np.abs(g - w16).max() <= 2 * own, (name, own)


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _one_pass(a, b):
    """a @ b on TF32-rounded operands: single-pass TF32."""
    return tf32_round_ref(a) @ tf32_round_ref(b)


@pytest.mark.parametrize("d,s_q,s_k", [(26, 40, 67), (96, 17, 130)])
def test_chip_smoke_bounds_hold_the_plain_versions_at_any_width(d, s_q, s_k):
    """chip_smoke.py's fp64 bounds for #7 fp32 at a width other than 64 and
    Sq ≠ Sk, rows 0 and 1 of the mask (the bounds leave out a row of padding
    alone): the forward's (``attention_accumulation_bound``) and the
    backward's (``attention_grad_bound``) hold the plain fp32 chain and the
    3xTF32 emulations, and reject single-pass TF32."""
    cs = _chip_smoke()
    q, k, v, mask, d_out = (a if a is None else a[:2] for a in _inputs(d, s_q, s_k, True, d))
    tq, tk, tv, tm, tdo = map(_t, (q, k, v, mask, d_out))
    scale = d ** -0.5
    bshd = [_bshd(t) for t in (tq, tk, tv)]
    exact, limit = cs.attention_accumulation_bound(*bshd, tm, scale)
    exact_g, limits = cs.attention_grad_bound(*bshd, tm, scale, _bshd(tdo))
    assert exact.shape == (2, s_q, H, d) and [g.shape for g in exact_g] == [
        (2, s_q, H, d), (2, s_k, H, d), (2, s_k, H, d)]

    def share(out, grads):
        fwd = ((_bshd(out).double() - exact) / limit).abs().max().item()
        return fwd, max(((_bshd(g).double() - e) / lim).abs().max().item()
                        for g, e, lim in zip(grads, exact_g, limits))

    lse = attention_lse_ref(tq, tk, tm, scale)
    plain = attention_ref(tq, tk, tv, tm, scale)
    emulated = attention_3xtf32_ref(tq, tk, tv, tm, scale)
    for out, grads in ((plain, attention_bwd_ref(tq, tk, tv, tm, scale, plain, lse, tdo)),
                       (emulated, attention_bwd_3xtf32_ref(tq, tk, tv, tm, scale, emulated, lse,
                                                           tdo))):
        assert max(share(out, grads)) < 1
    p = torch.softmax(_one_pass(tq, tk.transpose(-1, -2)) * scale
                      + (1.0 - tm[:, None, None, :]) * -1e9, dim=-1)
    one_pass = _one_pass(p, tv)
    grads = _bwd(tq, tk, tv, tm, scale, one_pass, lse, tdo, _one_pass)
    fwd, bwd = share(one_pass, grads)
    assert fwd > 1 and bwd > 1


def _layer_state(params):
    """One flax DecoderLayer's params (or gradients) as the port's
    DecoderLayer state_dict."""
    stub = {"kernel": np.zeros((1, 1), np.float32), "bias": np.zeros(1, np.float32)}
    sd = transformer_state_dict_from_jax({"embedding": stub, "fc": stub, "layer0": params}, 1)
    return {k[len("layer0."):]: v for k, v in sd.items() if k.startswith("layer0.")}


def test_decoder_layer_over_a_memory_trains_at_head_width_26():
    """DecoderLayer(zero_memory=False), 2 heads of 26, dropout 0, over a
    memory of 2·S + 3 positions whose last 5 are zeros: the cross-attention
    runs ``flash_attn`` (no mask, no live dropout) with Sk ≠ Sq. The output
    and every parameter's gradient of Σ out∘w against jax.grad of the JAX
    layer, each within 1e-5 of its tensor's largest value. A key projection's
    bias has a gradient of 0 in exact arithmetic (a softmax is unchanged by a
    constant added to a row's scores), so both sides' are rounding's: they are
    held below 1e-5 of the layer's largest gradient instead."""
    e, heads, s, b = 52, 2, 8, 2
    rng = np.random.default_rng(26)
    x, w = (rng.standard_normal((b, s, e)).astype(np.float32) for _ in range(2))
    memory = rng.standard_normal((b, 2 * s + 3, e)).astype(np.float32)
    memory[:, -5:] = 0.0
    layer = JaxDecoderLayer(e, heads, dim_feedforward=64, dropout=0.0, zero_memory=False)
    params = layer.init(jax.random.PRNGKey(7), jnp.asarray(x), jnp.asarray(memory),
                        jax_causal_mask(s))["params"]

    def loss(p):
        out = layer.apply({"params": p}, jnp.asarray(x), jnp.asarray(memory), jax_causal_mask(s))
        return (out * jnp.asarray(w)).sum(), out

    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(params)
    port = DecoderLayer(e, heads, dim_feedforward=64, dropout=0.0, zero_memory=False,
                        generator=torch.Generator().manual_seed(0), device="cpu")
    port.load_state_dict(_layer_state(jax.tree.map(np.asarray, params)))
    out, _ = port(torch.from_numpy(x), torch.from_numpy(memory), causal_mask(s))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    want_grads = _layer_state(jax.tree.map(np.asarray, grads))
    assert set(want_grads) == {n for n, _ in port.named_parameters()}
    largest = max(np.abs(g.numpy()).max() for g in want_grads.values())
    for name, param in port.named_parameters():
        assert param.grad is not None, name
        ref = want_grads[name].numpy()
        if name.endswith("k_proj.bias"):
            assert max(np.abs(param.grad.numpy()).max(), np.abs(ref).max()) <= 1e-5 * largest
            continue
        err = np.abs(param.grad.numpy() - ref).max()
        assert err <= 1e-5 * np.abs(ref).max(), (name, err, np.abs(ref).max())
    for proj in ("q_proj", "k_proj", "v_proj"):
        assert getattr(port.cross_attn, proj).weight.grad.abs().max() > 0


def test_bert_at_head_width_26_matches_jax():
    """A small BERT of 2 heads of 26 (hidden 52) with a padding mask (a row
    with a padded tail, a row of padding alone): the MLM hidden states against
    the JAX BERT's at test_torch_bert.py's tolerance (rtol 1e-4, atol 1e-5:
    fp32 LayerNorms that flax and torch take in other orders)."""
    small = dict(vocab_size=120, hidden_size=52, num_hidden_layers=2, num_attention_heads=2,
                 intermediate_size=64, max_position_embeddings=64)
    jax_net = JaxBertForMaskedLM(JaxBertConfig(**small))
    params = jax_net.init(jax.random.PRNGKey(1), jnp.zeros((1, 16), jnp.int32))["params"]
    net = BertForMaskedLM(BertConfig(**small), device="cpu")
    net.load_state_dict(bert_state_dict_from_jax(jax.tree.map(np.asarray, params)))
    rng = np.random.default_rng(2)
    ids = rng.integers(0, small["vocab_size"], (3, 20))
    mask = np.ones((3, 20), np.float32)
    mask[1, 12:] = 0.0
    mask[2] = 0.0
    want = np.asarray(jax_net.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask),
                                    return_mlm_hidden=True))
    with torch.no_grad():
        got = net(torch.from_numpy(ids), torch.from_numpy(mask), return_mlm_hidden=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_interfaces_take_a_key_length_of_their_own():
    """``scaled_attention`` ((B, H, S, D)) against the JAX function's XLA
    chain at Sq ≠ Sk; ``flash_attn`` on CPU tensors runs the plain version
    and counts no launch, and refuses shapes that do not pair."""
    q, k, v, mask, _ = _inputs(26, 17, 67, True, 3)
    want = np.asarray(jax_scaled_attention(*map(_j, (q, k, v)), kv_mask=_j(mask),
                                           sm_scale=0.2, use_flash=False))
    before = launch_count(flash_attn)
    got = scaled_attention(*map(_t, (q, k, v)), kv_mask=_t(mask), sm_scale=0.2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert launch_count(flash_attn) == before
    tq, tk = _bshd(_t(q)), _bshd(_t(k))
    with pytest.raises(ValueError, match="kv_mask"):
        flash_attn(tq, tk, tk, _t(mask)[:, :10], 0.2)
    with pytest.raises(ValueError, match="B, Sk, H, D"):
        flash_attn(tq, tk[..., :8], tk, None, 0.2)


def test_plan_takes_every_width_up_to_256():
    """The tuned forward at D = 64 only, the any-width forward at every other
    D to 256, in fp32 and bf16; the padding within the mma's granule, every
    block within SMEM_BYTES, each width in the narrowest class of 32, 64,
    128 or 256 columns that holds it; D = 257 (and a length of 0, and fp16)
    raise, naming them."""
    for dtype in (torch.float32, torch.bfloat16):
        granule = GRANULE[dtype]
        for d in range(1, MAX_D + 1):
            plan = plan_attention(d, dtype, 3, 5)
            assert plan.symbol in SIGNATURES
            assert (plan.symbol != "flash_any_fwd") == (d == TUNED_D)
            assert plan.padded % granule == 0 and 0 <= plan.padded - d < granule
            assert max(v for v in plan.smem.values() if v is not None) <= SMEM_BYTES
            assert plan.widest == next(c for c in (32, 64, 128, 256) if plan.padded <= c)
        with pytest.raises(ValueError, match=r"D=257.*256"):
            plan_attention(MAX_D + 1, dtype)
    with pytest.raises(ValueError, match="Sq=0"):
        plan_attention(26, torch.float32, 0, 4)
    with pytest.raises(ValueError, match="float16"):
        plan_attention(26, torch.float16)


def test_any_width_entry_points_switch_on_no_width():
    """The any-width forward and the backward's C entry points take D as a
    value and switch on no width of their own; each is bound in SIGNATURES."""
    for source in ("flash_any", "flash_bwd"):
        text = (CSRC / f"{source}.cu").read_text()
        found = re.findall(r'extern "C" int (\w+)\(([^)]*)\)\s*\{(.*?)\n\}', text, re.S)
        assert {name for name, _, _ in found} == {
            name for name, (src, _) in SIGNATURES.items() if src == source}
        for name, _, body in found:
            assert not re.search(r"case \d+:|\bd == \d+", body), name
