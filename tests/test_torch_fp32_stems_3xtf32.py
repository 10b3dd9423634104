"""The fp32 stems as their kernels compute them on the tensor cores, in 3xTF32
(msla_tpu_torch.ops.conv_stem.conv_stem_3xtf32_ref and
deconv_stem.deconv_stem_3xtf32_ref: every product split as hi = tf32(x), lo =
tf32(x − hi), lo·hi + hi·lo + hi·hi a k8 step, in the kernels' operand roles
and order), on the CPU against the JAX package's Pallas stems in interpret
mode and its XLA stems on the same fp32 inputs, outputs and hiddens, at
atol = rtol = 1e-5: small widths, and the full model's channel counts at
short lengths. Then chip_smoke.py's fp64 bound for the fp32 stems
(``stem_accumulation_bound``) on CPU tensors at the full channel counts: the
plain versions and the emulations sit inside it, single-pass TF32 products
do not, and ``stem_fp64_share`` fails above 1."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_layout import ncw, t32, torch_weight
from msla_tpu.ops.conv_stem import conv_stem_pallas, conv_stem_ref as jax_conv_stem_ref
from msla_tpu.ops.deconv_stem import deconv_stem_pallas, deconv_stem_ref as jax_deconv_stem_ref
from msla_tpu_torch.ops.conv_stem import conv_stem_3xtf32_ref, conv_stem_ref
from msla_tpu_torch.ops.deconv_stem import deconv_stem_3xtf32_ref, deconv_stem_ref
from msla_tpu_torch.ops.tf32 import tf32_round_ref

TOL = dict(rtol=1e-5, atol=1e-5)


def _conv_inputs(t, seed, b=2, c1=8, c2=16):
    """NWC x and flax kernels, scaled as the model's init scales them."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, 4)).astype(np.float32) * 0.3,
            (rng.standard_normal((4, 4, c1)) / np.sqrt(16)).astype(np.float32),
            (rng.standard_normal((c1,)) * 0.1).astype(np.float32),
            (rng.standard_normal((4, c1, c2)) / np.sqrt(4 * c1)).astype(np.float32),
            (rng.standard_normal((c2,)) * 0.1).astype(np.float32))


def _deconv_inputs(w, seed, b=2, c=16, c1=8):
    rng = np.random.default_rng(seed)
    return (rng.random((b, w, c)).astype(np.float32),
            (rng.standard_normal((4, c1, c)) / np.sqrt(2 * c)).astype(np.float32),
            (rng.standard_normal((c1,)) * 0.1).astype(np.float32),
            (rng.standard_normal((4, 4, c1)) / np.sqrt(2 * c1)).astype(np.float32),
            (rng.standard_normal((4,)) * 0.1).astype(np.float32))


def _port(x, k1, b1, k2, b2):
    return ncw(x), torch_weight(k1), t32(b1), torch_weight(k2), t32(b2)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), ncw(np.asarray(want)).numpy(), **TOL)


@pytest.mark.parametrize("t,c1,c2,tile,seed", [(64, 8, 16, 8, 0), (256, 8, 16, 16, 1),
                                               (64, 64, 128, 16, 2)])
def test_conv_stem_3xtf32_matches_jax_pallas_interpret(t, c1, c2, tile, seed):
    args = _conv_inputs(t, seed, c1=c1, c2=c2)
    want, want_h = conv_stem_pallas(*args, tile_w=tile, save_hidden=True, interpret=True)
    got, h1 = conv_stem_3xtf32_ref(*_port(*args))
    assert got.dtype == h1.dtype == torch.float32
    _close(got, want)
    _close(h1, want_h)


@pytest.mark.parametrize("t,c1,c2", [(64, 8, 16), (67, 8, 16), (130, 64, 128), (7, 64, 128)])
def test_conv_stem_3xtf32_matches_jax_xla(t, c1, c2):
    """Lengths not divisible by 4 included (the last h1 row real where T/2 is odd)."""
    args = _conv_inputs(t, 3, c1=c1, c2=c2)
    want, want_h = jax_conv_stem_ref(*args)
    got, h1 = conv_stem_3xtf32_ref(*_port(*args))
    assert got.shape == (2, c2, t // 4) and h1.shape == (2, c1, t // 2)
    _close(got, want)
    _close(h1, want_h)


@pytest.mark.parametrize("w,c,c1,tile,seed", [(16, 16, 8, 8, 0), (48, 16, 8, 24, 1),
                                              (16, 128, 64, 8, 2)])
def test_deconv_stem_3xtf32_matches_jax_pallas_interpret(w, c, c1, tile, seed):
    args = _deconv_inputs(w, seed, c=c, c1=c1)
    want, want_h = deconv_stem_pallas(*args, tile_w=tile, save_hidden=True, interpret=True)
    got, h = deconv_stem_3xtf32_ref(*_port(*args))
    assert got.dtype == h.dtype == torch.float32
    _close(got, want)
    _close(h, want_h)


@pytest.mark.parametrize("w,c,c1", [(16, 16, 8), (5, 16, 8), (1, 128, 64), (61, 128, 64)])
def test_deconv_stem_3xtf32_matches_jax_xla(w, c, c1):
    args = _deconv_inputs(w, 4, c=c, c1=c1)
    want, want_h = jax_deconv_stem_ref(*args)
    got, h = deconv_stem_3xtf32_ref(*_port(*args))
    assert got.shape == (2, 4, 4 * w) and h.shape == (2, c1, 2 * w)
    _close(got, want)
    _close(h, want_h)


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _one_pass(x, w1, b1, w2, b2, transposed):
    """The stem with single-pass TF32 products: both operands of each layer
    rounded to TF32, the exact products summed in fp32."""
    conv = F.conv_transpose1d if transposed else F.conv1d
    r = tf32_round_ref
    h = torch.relu(conv(r(x), r(w1), b1, 2, 1))
    out = conv(r(h), r(w2), b2, 2, 1)
    return (out if transposed else torch.relu(out)), h


@pytest.mark.parametrize("transposed", [False, True], ids=["K1", "K2"])
def test_chip_smoke_stem_bound_holds_the_plain_versions(transposed):
    """At the full channel counts (4 → 64 → 128; 128 → 64 → 4), T = 256 / W =
    64: the plain fp32 stem and the 3xTF32 emulation, output and hidden, sit
    inside ``stem_accumulation_bound``; single-pass TF32 products do not,
    and ``stem_fp64_share`` fails on them."""
    cs = _chip_smoke()
    if transposed:
        args = _port(*_deconv_inputs(64, 5, c=128, c1=64))
        plain, emulated = deconv_stem_ref(*args), deconv_stem_3xtf32_ref(*args)
    else:
        args = _port(*_conv_inputs(256, 6, c1=64, c2=128))
        plain, emulated = conv_stem_ref(*args), conv_stem_3xtf32_ref(*args)
    bounds = cs.stem_accumulation_bound(*args, transposed=transposed)
    exact, limit, exact_h, limit_h = bounds
    assert exact.shape == limit.shape == plain[0].shape and exact.dtype == torch.float64
    assert exact_h.shape == limit_h.shape == plain[1].shape

    def share(out, h):
        return max(((out.double() - exact).abs() / limit).max().item(),
                   ((h.double() - exact_h).abs() / limit_h).max().item())

    one_pass = _one_pass(*args, transposed)
    assert share(*plain) < 1 and share(*emulated) < 1
    assert share(*one_pass) > 1
    assert cs.stem_fp64_share("emulated", bounds, *emulated, plain=plain) < 1
    with pytest.raises(RuntimeError, match="3xTF32 accumulation"):
        cs.stem_fp64_share("one pass", bounds, *one_pass)
