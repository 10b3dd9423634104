"""msla_tpu_torch.ops.deconv_stem on the CPU (its plain version) against the JAX
package's fused decoder stem in interpret mode and its plain-XLA stem. fp32
both; atol = rtol = 1e-5 (sums of 32 and 16 products taken in another order)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_layout import ncw, t32, torch_weight
from msla_tpu.ops.deconv_stem import deconv_stem_pallas, deconv_stem_ref as jax_deconv_stem_ref
from msla_tpu_torch.ops._build import launch_count
from msla_tpu_torch.ops.deconv_stem import deconv_stem, deconv_stem_ref

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(b=2, w=64, c=16, c1=8, c_out=4, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, w, c)).astype(np.float32)
    k1 = (rng.standard_normal((4, c1, c)) * 0.2).astype(np.float32)
    b1 = (rng.standard_normal((c1,)) * 0.1).astype(np.float32)
    k2 = (rng.standard_normal((4, c_out, c1)) * 0.2).astype(np.float32)
    b2 = (rng.standard_normal((c_out,)) * 0.1).astype(np.float32)
    return q, k1, b1, k2, b2


def _port(q, k1, b1, k2, b2):
    return deconv_stem_ref(ncw(q), torch_weight(k1), t32(b1), torch_weight(k2), t32(b2))[0]


# output lengths t = 4w ∈ {64, 256, 192}
@pytest.mark.parametrize("w,tile", [(16, 8), (64, 16), (48, 24)])
def test_plain_matches_jax_pallas_interpret(w, tile):
    args = _inputs(w=w)
    want = np.asarray(deconv_stem_pallas(*args, tile_w=tile, interpret=True))
    np.testing.assert_allclose(ncw(want).numpy(), _port(*args).numpy(), **TOL)


@pytest.mark.parametrize("w", [16, 64, 48])
def test_plain_matches_jax_ref(w):
    args = _inputs(w=w, seed=1)
    want, _ = jax_deconv_stem_ref(*args)
    np.testing.assert_allclose(ncw(want).numpy(), _port(*args).numpy(), **TOL)


def test_single_tile_edges():
    """One JAX tile holds both edges: h[-1] and h[2W] are zero."""
    args = _inputs(w=16, seed=3)
    want = np.asarray(deconv_stem_pallas(*args, tile_w=16, interpret=True))
    np.testing.assert_allclose(ncw(want).numpy(), _port(*args).numpy(), **TOL)


def test_plain_matches_library_conv_transpose_pair():
    q, k1, b1, k2, b2 = _inputs(seed=5)
    q, k1, k2, b1, b2 = ncw(q), torch_weight(k1), torch_weight(k2), t32(b1), t32(b2)
    want = F.conv_transpose1d(F.relu(F.conv_transpose1d(q, k1, b1, 2, 1)), k2, b2, 2, 1)
    torch.testing.assert_close(deconv_stem_ref(q, k1, b1, k2, b2)[0], want, **TOL)


def test_wrapper_on_cpu_runs_the_plain_version():
    q, k1, b1, k2, b2 = _inputs(w=16, seed=6)
    args = (ncw(q), torch_weight(k1), t32(b1), torch_weight(k2), t32(b2))
    before = launch_count(deconv_stem)
    torch.testing.assert_close(deconv_stem(*args), deconv_stem_ref(*args)[0], rtol=0, atol=0)
    assert launch_count(deconv_stem) == before  # no kernel launched on the CPU


def test_training_forward_under_grad():
    """Under grad the stem runs its training forward, an autograd Function:
    the same output as without grad, and a gradient for its input."""
    q, k1, b1, k2, b2 = _inputs(w=16)
    q = ncw(q).requires_grad_()
    out = deconv_stem(q, torch_weight(k1), t32(b1), torch_weight(k2), t32(b2))
    assert type(out.grad_fn).__name__ == "_DeconvStemBackward"
    with torch.no_grad():
        want = deconv_stem(q, torch_weight(k1), t32(b1), torch_weight(k2), t32(b2))
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
