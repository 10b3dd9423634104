"""The stems' training path on the CPU against the JAX package.

* The save-hidden forwards: the plain (out, hidden) against
  conv_stem_pallas / deconv_stem_pallas(save_hidden=True) in interpret mode,
  at atol = rtol = 1e-5 (sums of 16 and 32 products taken in another order).
* The backwards: input and weight gradients through the port's
  autograd.Functions against jax.vjp of the JAX stems' plain-XLA versions, at
  rtol 1e-4 and atol 1e-6 (conv adjoints summed over a whole batch in another
  order). Odd T/4 and W check that the adjoints' lengths need no output
  padding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_layout import ncw, t32, torch_weight
from msla_tpu.ops.conv_stem import conv_stem_pallas, conv_stem_ref as jax_conv_stem_ref
from msla_tpu.ops.deconv_stem import (deconv_stem_pallas,
                                      deconv_stem_ref as jax_deconv_stem_ref)
from msla_tpu_torch.ops.conv_stem import conv_stem, conv_stem_ref, conv_stem_save_hidden
from msla_tpu_torch.ops.deconv_stem import (deconv_stem, deconv_stem_ref,
                                            deconv_stem_save_hidden)

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _rng(seed):
    return np.random.default_rng(seed)


def _conv_inputs(b=2, t=256, c0=4, c1=8, c2=16, seed=0):
    rng = _rng(seed)
    return (rng.standard_normal((b, t, c0)).astype(np.float32),
            (rng.standard_normal((4, c0, c1)) * 0.2).astype(np.float32),
            (rng.standard_normal((c1,)) * 0.1).astype(np.float32),
            (rng.standard_normal((4, c1, c2)) * 0.2).astype(np.float32),
            (rng.standard_normal((c2,)) * 0.1).astype(np.float32))


def _deconv_inputs(b=2, w=64, c=16, c1=8, c_out=4, seed=0):
    rng = _rng(seed)
    return (rng.standard_normal((b, w, c)).astype(np.float32),
            (rng.standard_normal((4, c1, c)) * 0.2).astype(np.float32),
            (rng.standard_normal((c1,)) * 0.1).astype(np.float32),
            (rng.standard_normal((4, c_out, c1)) * 0.2).astype(np.float32),
            (rng.standard_normal((c_out,)) * 0.1).astype(np.float32))


def _torch_args(x, w1, b1, w2, b2, grad=False):
    args = [ncw(x), torch_weight(w1), t32(b1), torch_weight(w2), t32(b2)]
    return [a.requires_grad_(grad) for a in args]


@pytest.mark.parametrize("t,tile", [(64, 8), (256, 16), (192, 48)])
def test_conv_save_hidden_matches_jax_pallas_interpret(t, tile):
    args = _conv_inputs(t=t, seed=1)
    want_out, want_h = conv_stem_pallas(*args, save_hidden=True, tile_w=tile, interpret=True)
    out, h = conv_stem_save_hidden(*_torch_args(*args))
    assert h.shape == (2, 8, t // 2)
    np.testing.assert_allclose(out.numpy(), ncw(want_out).numpy(), **FWD_TOL)
    np.testing.assert_allclose(h.numpy(), ncw(want_h).numpy(), **FWD_TOL)


@pytest.mark.parametrize("w,tile", [(16, 8), (64, 16), (48, 24)])
def test_deconv_save_hidden_matches_jax_pallas_interpret(w, tile):
    args = _deconv_inputs(w=w, seed=2)
    want_out, want_h = deconv_stem_pallas(*args, save_hidden=True, tile_w=tile,
                                          interpret=True)
    out, h = deconv_stem_save_hidden(*_torch_args(*args))
    assert h.shape == (2, 8, 2 * w)
    np.testing.assert_allclose(out.numpy(), ncw(want_out).numpy(), **FWD_TOL)
    np.testing.assert_allclose(h.numpy(), ncw(want_h).numpy(), **FWD_TOL)


def _check_grads(jax_fn, port_fn, args, g_shape, seed):
    g = _rng(seed).standard_normal(g_shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jax_fn(*a)[0], *map(jnp.asarray, args))
    want = vjp(jnp.asarray(g))
    targs = _torch_args(*args, grad=True)
    out = port_fn(*targs)
    out.backward(ncw(g))
    got_want = [(targs[0].grad, ncw(want[0])), (targs[1].grad, torch_weight(want[1])),
                (targs[2].grad, t32(want[2])), (targs[3].grad, torch_weight(want[3])),
                (targs[4].grad, t32(want[4]))]
    for name, (got, w) in zip(("input", "w1", "b1", "w2", "b2"), got_want):
        np.testing.assert_allclose(got.numpy(), w.numpy(), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("t", [64, 36, 200])  # T/4 = 16, 9 (odd), 50
def test_conv_stem_grads_match_jax_vjp(t):
    args = _conv_inputs(t=t, seed=3)
    _check_grads(jax_conv_stem_ref, conv_stem, args, (2, t // 4, 16), seed=4)


@pytest.mark.parametrize("w", [16, 9, 50])
def test_deconv_stem_grads_match_jax_vjp(w):
    args = _deconv_inputs(w=w, seed=5)
    _check_grads(jax_deconv_stem_ref, deconv_stem, args, (2, 4 * w, 4), seed=6)


def test_backwards_are_the_custom_functions_and_skip_an_input_without_grad():
    """The encoder's input never needs a gradient: the backward then skips
    the first layer's input adjoint, and the weight gradients are unchanged."""
    args = _conv_inputs(t=64, seed=7)
    x, *weights = _torch_args(*args, grad=True)
    out = conv_stem(x.detach(), *weights)
    assert type(out.grad_fn).__name__ == "_ConvStemBackward"
    out.sum().backward()
    no_dx = [w.grad.clone() for w in weights]
    for w in weights:
        w.grad = None
    conv_stem(x, *weights).sum().backward()
    for a, b in zip(no_dx, weights):
        torch.testing.assert_close(a, b.grad, rtol=0, atol=0)
    q = _torch_args(*_deconv_inputs(w=16, seed=8), grad=True)
    assert type(deconv_stem(*q).grad_fn).__name__ == "_DeconvStemBackward"


@pytest.mark.parametrize("ref,inputs", [(conv_stem_ref, _conv_inputs),
                                        (deconv_stem_ref, _deconv_inputs)])
def test_plain_hidden_is_relu_and_the_autograd_of_the_plain_version_agrees(ref, inputs):
    """The custom backward equals torch autograd through the plain version."""
    args = _torch_args(*inputs(seed=9), grad=True)
    out, h = ref(*args)
    assert (h >= 0).all()
    g = torch.from_numpy(_rng(10).standard_normal(out.shape).astype(np.float32))
    want = torch.autograd.grad(out, args, g)
    fn = conv_stem if ref is conv_stem_ref else deconv_stem
    got = torch.autograd.grad(fn(*args), args, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **GRAD_TOL)
