"""msla_tpu_torch.ops.flash_attn and nn.attention on the CPU against the JAX
package: ``attention_ref``/``scaled_attention`` against JAX ``scaled_attention``
(whose CPU dispatch is the XLA chain) on every row, padded query rows and a
sequence whose keys are all padding included, and ``MultiHeadAttention`` with
a key-padding mask against JAX's on the same weights. fp32 at atol 1e-5:
sums over 64 to 128 products in another order. Then the fp32 kernel's 3xTF32
products, emulated (``attention_3xtf32_ref``), against the JAX XLA chain at
the kernel's tolerance, and chip_smoke.py's fp64 accumulation bound for that
kernel on CPU tensors."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msla_tpu.nn.attention import MultiHeadAttention as JaxMultiHeadAttention
from msla_tpu.ops.flash_attn import _xla_attention
from msla_tpu.ops.flash_attn import scaled_attention as jax_scaled_attention
from msla_tpu_torch.nn.attention import MultiHeadAttention
from msla_tpu_torch.ops._build import launch_count
from msla_tpu_torch.ops.flash_attn import (attention_3xtf32_ref, attention_ref, flash_attn,
                                           scaled_attention)
from msla_tpu_torch.ops.tf32 import tf32_round_ref

B, H, S, D = 3, 2, 40, 16
TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, H, S, D)).astype(np.float32) for _ in range(3))


def _mask():
    """Row 0 attends everything, row 1 its first 25 keys, row 2 nothing."""
    am = np.ones((B, S), np.float32)
    am[1, 25:] = 0.0
    am[2, :] = 0.0
    return am


@pytest.mark.parametrize("masked", [True, False])
def test_plain_matches_jax_on_every_row(masked):
    q, k, v = _qkv()
    am = _mask() if masked else None
    want = np.asarray(jax_scaled_attention(
        *map(jnp.asarray, (q, k, v)), kv_mask=None if am is None else jnp.asarray(am),
        sm_scale=0.25, use_flash=False))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    tm = None if am is None else torch.from_numpy(am)
    got_ref = attention_ref(*t, tm, 0.25)
    got = scaled_attention(*t, kv_mask=tm, sm_scale=0.25)
    assert got.shape == (B, H, S, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got_ref.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_all_padding_keys_give_the_mean_of_v():
    """Every score of row 2 rounds to -1e9 in fp32, so its softmax is uniform:
    each query row gets the mean of v over all S keys, not 0/0."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1))
    out = scaled_attention(q, k, v, kv_mask=torch.from_numpy(_mask()), sm_scale=0.25)
    mean_v = v[2].mean(dim=1, keepdim=True).expand(H, S, D)
    torch.testing.assert_close(out[2], mean_v, **TOL)
    assert torch.isfinite(out).all()


def test_kernel_layout_wrapper_on_cpu_runs_the_plain_version():
    """``flash_attn`` takes (B, S, H, D), the projections' layout; on CPU
    tensors it runs the plain version and counts no launch."""
    q, k, v = (torch.from_numpy(a).transpose(1, 2).contiguous() for a in _qkv(2))
    am = torch.from_numpy(_mask())
    before = launch_count(flash_attn)
    got = flash_attn(q, k, v, am, 0.25)
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), am, 0.25)
    assert got.shape == (B, S, H, D)
    torch.testing.assert_close(got, want.transpose(1, 2), rtol=0, atol=0)
    assert launch_count(flash_attn) == before


def test_multi_head_attention_kv_mask_matches_jax():
    e, heads = 32, 4
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, e)).astype(np.float32)
    am = _mask()
    jax_mha = JaxMultiHeadAttention(e, heads)
    params = jax_mha.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(x),
                          jnp.asarray(x))["params"]
    want = np.asarray(jax_mha.apply({"params": params}, jnp.asarray(x), jnp.asarray(x),
                                    jnp.asarray(x), kv_mask=jnp.asarray(am)))
    mha = MultiHeadAttention(e, heads, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    sd = {}
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):  # Dense (in, out) → (out, in)
        sd[f"{name}.weight"] = torch.tensor(np.asarray(params[name]["kernel"]).T)
        sd[f"{name}.bias"] = torch.tensor(np.asarray(params[name]["bias"]))
    mha.load_state_dict(sd)
    xt = torch.from_numpy(x)
    got = mha(xt, xt, xt, kv_mask=torch.from_numpy(am))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_transformer_paths_wait():
    g = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError, match="queue item 4"):
        MultiHeadAttention(8, 2, dropout=0.1, generator=g, device="cpu")
    mha = MultiHeadAttention(8, 2, generator=g, device="cpu")
    x = torch.zeros((1, 4, 8))
    with pytest.raises(NotImplementedError, match="queue item 4"):
        mha(x, x, x, mask=torch.zeros((1, 1, 4, 4)))


def _ragged(seed, b=3, s=130, d=64):
    """(b, 2, s, d) q, k, v at a length that is no multiple of the kernel's
    64-key tile, and a mask: row 1 with its last 40 keys padding, row 2
    (when b = 3) all padding."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, 2, s, d)).astype(np.float32) for _ in range(3))
    am = np.ones((b, s), np.float32)
    am[1, s - 40:] = 0.0
    am[2:] = 0.0
    return q, k, v, am


@pytest.mark.parametrize("masked", [True, False])
def test_3xtf32_products_meet_the_kernels_fp32_tolerance(masked):
    """The fp32 kernel's arithmetic (Q·Kᵀ and P·V in 3xTF32, P split in
    registers) at S = 130 lies within atol = rtol = 1e-4 of the JAX XLA
    chain, the tolerance chip_smoke.py holds the kernel to on the card."""
    q, k, v, am = _ragged(11)
    mask = am if masked else None
    want = np.asarray(_xla_attention(*map(jnp.asarray, (q, k, v)),
                                     None if mask is None else jnp.asarray(mask), 0.125))
    got = attention_3xtf32_ref(*map(torch.from_numpy, (q, k, v)),
                               None if mask is None else torch.from_numpy(mask), 0.125)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_accumulation_bound_holds_the_plain_versions():
    """chip_smoke.py's fp64 bound for #7 fp32, on CPU tensors at a tiny size
    ((B, S, H, D) = (2, 130, 2, 64), a row with padded keys): the plain fp32
    chain and the 3xTF32 emulation sit inside it, single-pass TF32 products
    do not, and ``fp64_share`` fails above 1."""
    cs = _chip_smoke()
    q, k, v, am = (torch.from_numpy(a) for a in _ragged(12, b=2))
    bshd = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
    exact, limit = cs.attention_accumulation_bound(*bshd, am, 0.125)
    assert exact.shape == limit.shape == (2, 130, 2, 64) and exact.dtype == torch.float64

    def share(out):  # (B, H, S, D) fp32
        return ((out.transpose(1, 2).double() - exact).abs() / limit).max().item()

    plain, emulated = attention_ref(q, k, v, am, 0.125), attention_3xtf32_ref(q, k, v, am, 0.125)
    assert share(plain) < 1 and share(emulated) < 1
    one_pass = torch.softmax(tf32_round_ref(q) @ tf32_round_ref(k).transpose(-1, -2) * 0.125
                             + (1.0 - am[:, None, None, :]) * -1e9, dim=-1)
    one_pass = tf32_round_ref(one_pass) @ tf32_round_ref(v)
    assert share(one_pass) > 1
    assert cs.fp64_share("plain", plain.transpose(1, 2), *bshd, am) < 1
    with pytest.raises(RuntimeError, match="3xTF32 accumulation"):
        cs.fp64_share("one pass", one_pass.transpose(1, 2), *bshd, am)
