"""msla_tpu_torch.ops.flash_attn's plain version on bf16 q, k, v on the CPU
against the JAX package's XLA attention chain (``scaled_attention`` with
use_flash=False, ``_xla_attention``) on the same bf16 operands, every row:
fp32 scores of the exact products, an fp32 softmax, the probabilities rounded
to bf16 before ``@ v`` and an fp32 output. Within 2⁻⁸·Σₖ pₖ|vₖ| + 1e-5 a row
and column: the two sum the scores in another order, so a probability at a
bf16 rounding boundary may round the other way (half an ulp each, 2⁻⁹)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msla_tpu.ops.flash_attn import scaled_attention as jax_scaled_attention
from msla_tpu_torch.ops._build import launch_count
from msla_tpu_torch.ops.flash_attn import attention_ref, flash_attn, scaled_attention

B, H, S, D = 3, 2, 40, 16
BF = torch.bfloat16


def _qkv(seed=0):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal((B, H, S, D)) * 1.5).astype(np.float32)
                 for _ in range(3))


def _mask():
    """Row 0 attends everything, row 1 its first 25 keys, row 2 nothing."""
    am = np.ones((B, S), np.float32)
    am[1, 25:] = 0.0
    am[2, :] = 0.0
    return am


def _limit(q, k, v, am) -> np.ndarray:
    """2⁻⁸·Σₖ pₖ|vₖ| + 1e-5 per (b, h, row, column), p in fp32 from fp64 scores."""
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k.astype(np.float64)) * 0.25
    if am is not None:
        s = s + (1.0 - am[:, None, None, :]) * -1e9
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return 2.0 ** -8 * np.einsum("bhqk,bhkd->bhqd", p, np.abs(v.astype(np.float64))) + 1e-5


@pytest.mark.parametrize("masked", [True, False])
def test_bf16_plain_matches_jax_xla_chain(masked):
    q, k, v = _qkv()
    am = _mask() if masked else None
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jax_scaled_attention(
        jq, jk, jv, kv_mask=None if am is None else jnp.asarray(am), sm_scale=0.25,
        use_flash=False))
    assert want.dtype == np.float32
    tq, tk, tv = (torch.from_numpy(a).to(BF) for a in (q, k, v))
    tm = None if am is None else torch.from_numpy(am)
    got = attention_ref(tq, tk, tv, tm, 0.25)
    assert got.dtype == torch.float32 and got.shape == (B, H, S, D)
    rounded = [t.float().numpy() for t in (tq, tk, tv)]
    assert (np.abs(got.numpy() - want) <= _limit(*rounded, am)).all()
    torch.testing.assert_close(scaled_attention(tq, tk, tv, kv_mask=tm, sm_scale=0.25), got,
                               rtol=0, atol=0)


def test_bf16_rounds_the_probabilities():
    """The bf16 function is not the fp32 one on the same rounded operands:
    the probabilities are rounded to bf16 before ``@ v``."""
    q, k, v = (torch.from_numpy(a).to(BF) for a in _qkv(1))
    got = attention_ref(q, k, v, None, 0.25)
    fp32 = attention_ref(q.float(), k.float(), v.float(), None, 0.25)
    assert 0 < (got - fp32).abs().max().item() <= 2.0 ** -8 * v.float().abs().max().item()


def test_bf16_wrapper_on_cpu_takes_the_projections_layout():
    q, k, v = (torch.from_numpy(a).to(BF).transpose(1, 2).contiguous() for a in _qkv(2))
    mask = torch.from_numpy(_mask())
    before = launch_count(flash_attn)
    out = flash_attn(q, k, v, mask, 0.25)
    assert out.dtype == torch.float32 and out.shape == (B, S, H, D)
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask, 0.25)
    torch.testing.assert_close(out, want.transpose(1, 2), rtol=0, atol=0)
    assert launch_count(flash_attn) == before  # no kernel launched on the CPU
