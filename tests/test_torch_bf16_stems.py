"""The stems' plain versions in bf16 (msla_tpu_torch.ops.conv_stem_ref and
deconv_stem_ref on bf16 x/q, w1, w2 and fp32 biases) on the CPU against the
JAX package's Pallas stems in interpret mode on the same bf16 operands, the
function the port's bf16 kernels compute: within 1 bf16 ulp of the larger
value (both sum the same exact products in fp32, in another order, then round
h and the output to bf16; these inputs give the same bits). Against the JAX
package's XLA stems, which add the bias after casting it to bf16, within
4 bf16 ulps of the output's largest value. And K1's lengths that are not a
multiple of 4, fp32 and bf16, against the JAX XLA stem; and the bf16 stems
under grad (their values in tests/test_torch_bf16_train.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_layout import ncw, t32, torch_weight
from msla_tpu.ops.conv_stem import conv_stem_pallas, conv_stem_ref as jax_conv_stem_ref
from msla_tpu.ops.deconv_stem import _phase_weights_1, _phase_weights_2, deconv_stem_pallas
from msla_tpu.ops.deconv_stem import deconv_stem_ref as jax_deconv_stem_ref
from msla_tpu_torch.ops._build import launch_count
from msla_tpu_torch.ops.conv_stem import conv_stem, conv_stem_ref, conv_stem_save_hidden
from msla_tpu_torch.ops.deconv_stem import (deconv_stem, deconv_stem_phase_ref, deconv_stem_ref,
                                            phase_operands)

BF = torch.bfloat16


def bf16_ulps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|got − want| in bf16 ulps of the larger of the two magnitudes."""
    m = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(m, np.finfo(np.float32).tiny))) - 7)
    return np.abs(got - want) / ulp


def _stem_inputs(t, seed, b=2, c0=4, c1=8, c2=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, c0)).astype(np.float32),
            (rng.standard_normal((4, c0, c1)) * 0.2).astype(np.float32),
            (rng.standard_normal((c1,)) * 0.1).astype(np.float32),
            (rng.standard_normal((4, c1, c2)) * 0.2).astype(np.float32),
            (rng.standard_normal((c2,)) * 0.1).astype(np.float32))


def _jax_bf16(x, w1, b1, w2, b2):
    """The JAX stems' bf16 operands: x and the kernels bf16, the biases fp32."""
    bf = jnp.bfloat16
    return (jnp.asarray(x, bf), jnp.asarray(w1, bf), jnp.asarray(b1), jnp.asarray(w2, bf),
            jnp.asarray(b2))


def _port_bf16(x, w1, b1, w2, b2):
    return (ncw(x).to(BF), torch_weight(w1).to(BF), t32(b1), torch_weight(w2).to(BF), t32(b2))


def _f32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


@pytest.mark.parametrize("t,tile,seed", [(64, 8, 0), (256, 16, 1), (192, 48, 2)])
def test_conv_stem_bf16_matches_jax_pallas_interpret(t, tile, seed):
    args = _stem_inputs(t, seed)
    want = _f32(conv_stem_pallas(*_jax_bf16(*args), tile_w=tile, interpret=True))
    got, h1 = conv_stem_ref(*_port_bf16(*args))
    assert got.dtype == h1.dtype == BF
    assert bf16_ulps(got.float().numpy(), ncw(want).numpy()).max() <= 1


@pytest.mark.parametrize("t", [64, 256])
def test_conv_stem_bf16_hidden_matches_jax_pallas_interpret(t):
    args = _stem_inputs(t, 3)
    _, want = conv_stem_pallas(*_jax_bf16(*args), tile_w=16, save_hidden=True, interpret=True)
    got = conv_stem_ref(*_port_bf16(*args))[1]
    assert bf16_ulps(got.float().numpy(), ncw(_f32(want)).numpy()).max() <= 1


@pytest.mark.parametrize("t", [64, 192])
def test_conv_stem_bf16_near_jax_xla(t):
    args = _stem_inputs(t, 4)
    want = ncw(_f32(jax_conv_stem_ref(*_jax_bf16(*args))[0])).numpy()
    got = conv_stem_ref(*_port_bf16(*args))[0].float().numpy()
    assert np.abs(got - want).max() <= 4 * 2.0 ** -8 * np.abs(want).max()


@pytest.mark.parametrize("w,tile,seed", [(16, 8, 0), (64, 16, 1), (48, 24, 2)])
def test_deconv_stem_bf16_matches_jax_pallas_interpret(w, tile, seed):
    rng = np.random.default_rng(seed)
    args = (rng.standard_normal((2, w, 16)).astype(np.float32),
            (rng.standard_normal((4, 8, 16)) * 0.2).astype(np.float32),
            (rng.standard_normal((8,)) * 0.1).astype(np.float32),
            (rng.standard_normal((4, 4, 8)) * 0.2).astype(np.float32),
            (rng.standard_normal((4,)) * 0.1).astype(np.float32))
    want = ncw(_f32(deconv_stem_pallas(*_jax_bf16(*args), tile_w=tile, interpret=True)))
    got, h = deconv_stem_ref(*_port_bf16(*args))
    assert got.dtype == h.dtype == BF
    assert bf16_ulps(got.float().numpy(), want.numpy()).max() <= 1
    near = ncw(_f32(jax_deconv_stem_ref(*_jax_bf16(*args))[0])).numpy()
    assert np.abs(got.float().numpy() - near).max() <= 4 * 2.0 ** -8 * np.abs(near).max()


@pytest.mark.parametrize("t", [62, 63, 65, 66, 4, 7])
@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_conv_stem_takes_any_length_as_jax_xla(t, dtype):
    """floor(T/2) hidden rows and floor(T/4) outputs, as the JAX XLA stem gives
    them (fp32 at 1e-5; bf16 against the port's own fp32 at 2 bf16 ulps of the
    largest value, since the XLA stem rounds its bias to bf16)."""
    args = _stem_inputs(t, 5)
    want, want_h = (ncw(_f32(a)) for a in jax_conv_stem_ref(*args))
    port = (ncw(args[0]), torch_weight(args[1]), t32(args[2]), torch_weight(args[3]),
            t32(args[4]))
    if dtype == BF:
        port = (port[0].to(BF), port[1].to(BF), port[2], port[3].to(BF), port[4])
    got, h1 = conv_stem_ref(*port)
    assert got.shape == (2, 16, t // 4) and h1.shape == (2, 8, t // 2)
    assert torch.equal(conv_stem(*port), got)
    tol = 1e-5 if dtype == torch.float32 else 2 * 2.0 ** -8 * want.abs().max().item()
    torch.testing.assert_close(got.float(), want, rtol=0 if dtype == BF else 1e-5, atol=tol)
    torch.testing.assert_close(h1.float(), want_h, rtol=0 if dtype == BF else 1e-5,
                               atol=tol if dtype == BF else 1e-5)


def test_wrappers_on_cpu_run_the_bf16_plain_versions():
    args = _port_bf16(*_stem_inputs(64, 6))
    before = launch_count(conv_stem)
    assert torch.equal(conv_stem(*args), conv_stem_ref(*args)[0])
    out, h1 = conv_stem_save_hidden(*args)
    assert out.dtype == h1.dtype == BF
    q = torch.randn((2, 16, 16), generator=torch.Generator().manual_seed(0)).to(BF)
    w1, w2 = torch.randn((16, 8, 4)).to(BF), torch.randn((8, 4, 4)).to(BF)
    b1, b2 = torch.zeros(8), torch.zeros(4)
    assert torch.equal(deconv_stem(q, w1, b1, w2, b2), deconv_stem_ref(q, w1, b1, w2, b2)[0])
    assert launch_count(conv_stem) == before  # no kernel launched on the CPU


def test_bf16_stems_have_their_autograd_functions():
    """Under grad the bf16 stems are their autograd.Functions, with bf16 input
    and weight gradients and fp32 bias gradients, as the JAX package's
    _fused_bwd (tests/test_torch_bf16_train.py holds the values)."""
    x, w1, b1, w2, b2 = _port_bf16(*_stem_inputs(64, 7))
    weights = [w.requires_grad_() for w in (w1, b1, w2, b2)]
    out = conv_stem(x, *weights)
    assert type(out.grad_fn).__name__ == "_ConvStemBackward" and out.dtype == BF
    out.float().sum().backward()
    assert [w.grad.dtype for w in weights] == [BF, torch.float32, BF, torch.float32]
    q = torch.randn((1, 16, 8)).to(BF)
    weights = [torch.randn((16, 8, 4)).to(BF).requires_grad_(), torch.zeros(8).requires_grad_(),
               torch.randn((8, 4, 4)).to(BF).requires_grad_(), torch.zeros(4).requires_grad_()]
    out = deconv_stem(q, *weights)
    assert type(out.grad_fn).__name__ == "_DeconvStemBackward" and out.dtype == BF
    out.float().sum().backward()
    assert [w.grad.dtype for w in weights] == [BF, torch.float32, BF, torch.float32]


def test_lengths_below_4_are_refused():
    x, w1, b1, w2, b2 = _port_bf16(*_stem_inputs(8, 8))
    with pytest.raises(ValueError, match="T >= 4"):
        conv_stem(x[..., :3], w1, b1, w2, b2)


def _deconv_weights(seed, c=16, c1=8, c_out=4):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((4, c1, c)) * 0.2).astype(np.float32),
            (rng.standard_normal((c1,)) * 0.1).astype(np.float32),
            (rng.standard_normal((4, c_out, c1)) * 0.2).astype(np.float32),
            (rng.standard_normal((c_out,)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_phase_operands_are_the_pallas_kernels(dtype):
    """W1' and W2' as the bf16 kernel packs them: the same values as the JAX
    _phase_weights_1/_2 (flax layouts) at the places the kernel's rows and
    columns give them: W1'[o][c] of he from q[r-1] is _phase_weights_1[0][c][o],
    and so on; W2'[4o + j][64 g + c] is _phase_weights_2[g][c][4 j + o] (C_out = 4)."""
    k1, _, k2, _ = _deconv_weights(9)
    w1p, w2p = phase_operands(torch_weight(k1).to(dtype), torch_weight(k2).to(dtype))
    p1 = torch.from_numpy(np.array(_phase_weights_1(jnp.asarray(k1)))).to(dtype)
    p2 = torch.from_numpy(np.array(_phase_weights_2(jnp.asarray(k2)))).to(dtype)
    c1, c = k1.shape[1], k1.shape[2]
    assert w1p.shape == (2 * c1, 2 * c) and w2p.shape == (16, 4 * c1)
    want1 = torch.cat([torch.cat([p1[0].T, p1[1].T], 1), torch.cat([p1[2].T, p1[3].T], 1)], 0)
    assert torch.equal(w1p, want1)
    want2 = p2.reshape(4 * c1, 4, 4).permute(2, 1, 0).reshape(16, 4 * c1)  # [o][j] <- [j][o]
    assert torch.equal(w2p, want2)


@pytest.mark.parametrize("w", [1, 2, 13, 40])
def test_phase_formulation_is_the_stem(w):
    """The stem as the bf16 kernel computes it (deconv_stem_phase_ref: both
    layers as products with the stacked operands, the halo rows zero): in
    fp32 within 1e-5 of deconv_stem_ref at widths from 1, and in bf16 within
    1 bf16 ulp of the JAX Pallas kernel in interpret mode."""
    k1, b1, k2, b2 = _deconv_weights(10 + w)
    q = np.random.default_rng(w).standard_normal((2, w, 16)).astype(np.float32)
    port = (ncw(q), torch_weight(k1), t32(b1), torch_weight(k2), t32(b2))
    got, h = deconv_stem_phase_ref(*port)
    want, want_h = deconv_stem_ref(*port)
    assert got.shape == (2, 4, 4 * w) and h.shape == (2, 8, 2 * w)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h, want_h, rtol=1e-5, atol=1e-5)
    if w % 8 == 0:
        pallas = ncw(_f32(deconv_stem_pallas(*_jax_bf16(q, k1, b1, k2, b2), tile_w=8,
                                             interpret=True)))
        got16 = deconv_stem_phase_ref(*_port_bf16(q, k1, b1, k2, b2))[0]
        assert got16.dtype == BF
        assert bf16_ulps(got16.float().numpy(), pallas.numpy()).max() <= 1


def _pallas_stem_operands(w1, w2):
    """w1e, w1oa, w1ob and w2 as msla_tpu/ops/conv_stem.py:101-105 builds them
    for the Pallas kernel, from flax-layout w1 (4, C0, C1) and w2 (4, C1, C2)."""
    c0, c1 = w1.shape[1], w1.shape[2]
    w1r = jnp.asarray(w1).reshape(4 * c0, c1)          # row tap·C0 + c0
    half = 2 * c0
    zeros = jnp.zeros((half, c1), w1r.dtype)
    w1oa = jnp.concatenate([zeros, w1r[:half]], axis=0)
    w1ob = jnp.concatenate([w1r[half:], zeros], axis=0)
    return (np.array(w1r), np.array(w1oa), np.array(w1ob), np.array(jnp.asarray(w2)))


@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_stem_operands_are_the_pallas_kernels(dtype):
    """W1 and W2' as the bf16 K1 kernel's prologue packs them: W1[c1][c0·4 +
    tap] is the Pallas kernel's w1e[tap·C0 + c0][c1] (the even phase), and
    for the odd phase, which the Pallas kernel straddles over two packed rows,
    w1oa[2·C0 + tap·C0 + c0][c1] for taps 0-1 and w1ob[(tap − 2)·C0 + c0][c1]
    for taps 2-3, the other halves zero; W2'[c2][tap·C1 + c1] is its
    w2[tap][c1][c2]."""
    from msla_tpu_torch.ops.conv_stem import stem_operands

    _, k1, _, k2, _ = _stem_inputs(8, 11)
    w1p, w2p = stem_operands(torch_weight(k1).to(dtype), torch_weight(k2).to(dtype))
    w1e, w1oa, w1ob, w2 = (torch.from_numpy(a).to(dtype) for a in _pallas_stem_operands(k1, k2))
    c0, c1, c2 = k1.shape[1], k1.shape[2], k2.shape[2]
    assert w1p.shape == (c1, 4 * c0) and w2p.shape == (c2, 4 * c1)
    for c0i in range(c0):
        for tap in range(4):
            col = w1p[:, c0i * 4 + tap]
            assert torch.equal(col, w1e[tap * c0 + c0i])
            odd = w1oa[2 * c0 + tap * c0 + c0i] if tap < 2 else w1ob[(tap - 2) * c0 + c0i]
            assert torch.equal(col, odd)
    assert not w1oa[:2 * c0].any() and not w1ob[2 * c0:].any()
    for tap in range(4):
        assert torch.equal(w2p[:, tap * c1:(tap + 1) * c1], w2[tap].T)


@pytest.mark.parametrize("t", [4, 7, 62, 63, 65, 256])
def test_stem_phase_formulation_is_the_stem(t):
    """The stem as the bf16 K1 kernel computes it (conv_stem_phase_ref: each h1
    row from its packed window, conv2 on the odd and even rows as two
    128-deep halves added in fp32): in fp32 within 1e-5 of conv_stem_ref, out
    and hidden, at lengths from 4 and not divisible by 4; in bf16 within
    1 bf16 ulp of the JAX Pallas kernel in interpret mode, out and hidden,
    where the Pallas kernel takes the length."""
    from msla_tpu_torch.ops.conv_stem import conv_stem_phase_ref

    args = _stem_inputs(t, 20 + t)
    port = (ncw(args[0]), torch_weight(args[1]), t32(args[2]), torch_weight(args[3]),
            t32(args[4]))
    got, h1 = conv_stem_phase_ref(*port)
    want, want_h = conv_stem_ref(*port)
    assert got.shape == (2, 16, t // 4) and h1.shape == (2, 8, t // 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h1, want_h, rtol=1e-5, atol=1e-5)
    if t % 32 == 0:
        out, hidden = conv_stem_pallas(*_jax_bf16(*args), tile_w=16, save_hidden=True,
                                       interpret=True)
        got16, h16 = conv_stem_phase_ref(*_port_bf16(*args))
        assert got16.dtype == h16.dtype == BF
        assert bf16_ulps(got16.float().numpy(), ncw(_f32(out)).numpy()).max() <= 1
        assert bf16_ulps(h16.float().numpy(), ncw(_f32(hidden)).numpy()).max() <= 1
