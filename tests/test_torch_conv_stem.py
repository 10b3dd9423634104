"""msla_tpu_torch.ops.conv_stem on the CPU (its plain version) against the JAX
package's fused stem in interpret mode and its plain-XLA stem. fp32 both;
atol = rtol = 1e-5 (sums of 16 and 32 products taken in another order)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_layout import ncw, t32, torch_weight
from msla_tpu.ops.conv_stem import conv_stem_pallas, conv_stem_ref as jax_conv_stem_ref
from msla_tpu_torch.ops._build import launch_count
from msla_tpu_torch.ops.conv_stem import conv_stem, conv_stem_ref

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(b=2, t=256, c0=4, c1=8, c2=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, c0)).astype(np.float32)
    w1 = (rng.standard_normal((4, c0, c1)) * 0.2).astype(np.float32)
    b1 = (rng.standard_normal((c1,)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((4, c1, c2)) * 0.2).astype(np.float32)
    b2 = (rng.standard_normal((c2,)) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2


def _port(x, w1, b1, w2, b2):
    return conv_stem_ref(ncw(x), torch_weight(w1), t32(b1), torch_weight(w2), t32(b2))[0]


@pytest.mark.parametrize("t,tile", [(64, 8), (256, 16), (192, 48)])
def test_plain_matches_jax_pallas_interpret(t, tile):
    args = _inputs(t=t)
    want = np.asarray(conv_stem_pallas(*args, tile_w=tile, interpret=True))
    np.testing.assert_allclose(ncw(want).numpy(), _port(*args).numpy(), **TOL)


@pytest.mark.parametrize("t", [64, 256, 192])
def test_plain_matches_jax_ref(t):
    args = _inputs(t=t, seed=1)
    want, _ = jax_conv_stem_ref(*args)
    np.testing.assert_allclose(ncw(want).numpy(), _port(*args).numpy(), **TOL)


def test_single_tile_edges():
    """One JAX tile holds both edges: out1[-1] and out1[T/2] are conv2 padding."""
    args = _inputs(t=64, seed=3)
    want = np.asarray(conv_stem_pallas(*args, tile_w=16, interpret=True))
    np.testing.assert_allclose(ncw(want).numpy(), _port(*args).numpy(), **TOL)


def test_plain_matches_library_conv_pair():
    x, w1, b1, w2, b2 = _inputs(seed=5)
    x, w1, w2, b1, b2 = ncw(x), torch_weight(w1), torch_weight(w2), t32(b1), t32(b2)
    want = F.relu(F.conv1d(F.relu(F.conv1d(x, w1, b1, 2, 1)), w2, b2, 2, 1))
    torch.testing.assert_close(conv_stem_ref(x, w1, b1, w2, b2)[0], want, **TOL)


def test_wrapper_on_cpu_runs_the_plain_version():
    x, w1, b1, w2, b2 = _inputs(t=64, seed=6)
    args = (ncw(x), torch_weight(w1), t32(b1), torch_weight(w2), t32(b2))
    before = launch_count(conv_stem)
    torch.testing.assert_close(conv_stem(*args), conv_stem_ref(*args)[0], rtol=0, atol=0)
    assert launch_count(conv_stem) == before  # no kernel launched on the CPU


@pytest.mark.parametrize("t", [3, 62, 63, 65])
def test_rejects_length_not_divisible_by_4(t):
    """A length T not divisible by 4 is taken now, as the JAX package's XLA
    stem takes it: floor(T/4) columns equal to its conv_stem_ref's; only T < 4
    is refused."""
    x, w1, b1, w2, b2 = _inputs(t=64)
    x = x[:, :t]
    args = (ncw(x), torch_weight(w1), t32(b1), torch_weight(w2), t32(b2))
    if t < 4:
        with pytest.raises(ValueError, match="T >= 4"):
            conv_stem(*args)
        return
    got = conv_stem(*args)
    assert got.shape == (2, 16, t // 4)
    want, _ = jax_conv_stem_ref(x, w1, b1, w2, b2)
    np.testing.assert_allclose(got.numpy(), ncw(want).numpy(), **TOL)


def test_training_forward_under_grad():
    """Under grad the stem runs its training forward, an autograd Function:
    the same output as without grad, and a gradient for every weight."""
    x, w1, b1, w2, b2 = _inputs(t=64)
    w1 = torch_weight(w1).requires_grad_()
    out = conv_stem(ncw(x), w1, t32(b1), torch_weight(w2), t32(b2))
    assert type(out.grad_fn).__name__ == "_ConvStemBackward"
    with torch.no_grad():
        want = conv_stem(ncw(x), w1, t32(b1), torch_weight(w2), t32(b2))
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    out.sum().backward()
    assert w1.grad is not None and torch.isfinite(w1.grad).all()
