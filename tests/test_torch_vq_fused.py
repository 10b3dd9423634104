"""The fused training VQ on the CPU against the JAX package's fused custom VJP,
its Pallas kernels run in interpret mode (as tests/test_vq_fused.py runs them).

Forward fields: ids equal; q, the losses and perplexity at rtol 1e-5 (the
squared-error sum is taken in another order). Gradients of the composite loss
of tests/test_vq_fused.py at rtol 1e-5, atol 1e-6. The codebook-gradient
plain version against jax.ops.segment_sum at rtol 1e-5, atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msla_tpu.ops import vq_fused as jax_vq_fused
from msla_tpu.ops.vq import _vector_quantize_fused
from msla_tpu_torch.ops._build import launch_count
from msla_tpu_torch.ops.vq import vector_quantize
from msla_tpu_torch.ops.vq_fused import (vq_codebook_grad, vq_codebook_grad_ref, vq_fused_fwd,
                                         vq_fused_fwd_ref)

jax_vq_fused.INTERPRET = True

BETA = 0.25
TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(n=100, d=8, k=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, n // 4, d)).astype(np.float32)
    cb = rng.standard_normal((k, d)).astype(np.float32)
    return x, cb


@pytest.mark.parametrize("n,d,k", [(100, 8, 16), (52, 8, 16), (2052, 64, 512)])
def test_forward_fields_match_jax_fused(n, d, k):
    """n = 52 leaves padded rows in JAX's last tile, 2052 in its second tile
    of 2048: the counts and the loss must not see them."""
    x, cb = _inputs(n, d, k, seed=n)
    want = _vector_quantize_fused(jnp.asarray(x), jnp.asarray(cb), BETA)
    got = vector_quantize(torch.from_numpy(x), torch.from_numpy(cb), BETA)
    np.testing.assert_array_equal(got.encoding_indices.numpy(),
                                  np.asarray(want.encoding_indices))
    np.testing.assert_allclose(got.quantized.numpy(), np.asarray(want.quantized), **TOL)
    np.testing.assert_allclose(got.quantized_ste.numpy(), np.asarray(want.quantized_ste),
                               **TOL)
    for name in ("embedding_loss", "commitment_loss", "perplexity"):
        np.testing.assert_allclose(float(getattr(got, name)), float(getattr(want, name)),
                                   rtol=1e-5, err_msg=name)


def test_plain_forward_matches_jax_kernel():
    x, cb = _inputs(60, 8, 16, seed=1)
    flat = x.reshape(-1, 8)
    want = jax_vq_fused.vq_fused_fwd_pallas(jnp.asarray(flat), jnp.asarray(cb), tile=16)
    q, idx, counts, sq = vq_fused_fwd_ref(torch.from_numpy(flat), torch.from_numpy(cb))
    assert idx.dtype == torch.int32 and counts.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(q.numpy(), np.asarray(want[0]))  # exact codebook rows
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(float(sq), float(want[3]), rtol=1e-5)


def _composite(w):
    def loss(r):
        return (r.quantized_ste * w).sum() * 0.7 + r.embedding_loss + r.commitment_loss \
            + 0.3 * (r.quantized ** 2).sum()
    return loss


@pytest.mark.parametrize("n,d,k", [(64, 8, 16), (52, 8, 16)])
def test_gradients_match_jax_fused_vjp(n, d, k):
    """The composite loss of tests/test_vq_fused.py touches every path: the
    STE output, both losses and the raw quantized rows."""
    x, cb = _inputs(n, d, k, seed=2)
    w = np.random.default_rng(3).standard_normal((d,)).astype(np.float32)
    want_dx, want_dcb = jax.grad(
        lambda x, cb: _composite(jnp.asarray(w))(_vector_quantize_fused(x, cb, BETA)),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(cb))
    tx = torch.from_numpy(x).requires_grad_()
    tcb = torch.from_numpy(cb).requires_grad_()
    _composite(torch.from_numpy(w))(vector_quantize(tx, tcb, BETA)).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx), **TOL)
    np.testing.assert_allclose(tcb.grad.numpy(), np.asarray(want_dcb), **TOL)


def test_each_output_sends_its_gradient_to_its_own_input():
    """quantized_ste's cotangent reaches x only and quantized's reaches the
    codebook only, though the two are equal in value; β scales the commitment
    loss alone."""
    x, cb = _inputs(64, 8, 16, seed=4)
    tx = torch.from_numpy(x).requires_grad_()
    tcb = torch.from_numpy(cb).requires_grad_()
    r = vector_quantize(tx, tcb, BETA)
    assert r.quantized_ste is not r.quantized
    torch.testing.assert_close(r.commitment_loss, BETA * r.embedding_loss)
    dx, dcb = torch.autograd.grad(r.quantized_ste.sum(), (tx, tcb), allow_unused=True)
    assert torch.equal(dx, torch.ones_like(tx)) and (dcb is None or not dcb.any())
    r = vector_quantize(tx, tcb, BETA)
    dx, dcb = torch.autograd.grad(r.quantized.sum(), (tx, tcb), allow_unused=True)
    assert (dx is None or not dx.any()) and dcb.sum().item() == pytest.approx(x.size)
    assert r.encoding_indices.requires_grad is False


def test_codebook_grad_plain_matches_segment_sum():
    rng = np.random.default_rng(5)
    g = rng.standard_normal((70, 8)).astype(np.float32)
    idx = rng.integers(0, 16, (70,)).astype(np.int32)
    want = jax.ops.segment_sum(jnp.asarray(g), jnp.asarray(idx), num_segments=16)
    got = vq_codebook_grad_ref(torch.from_numpy(g), torch.from_numpy(idx), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    kernel = jax_vq_fused.vq_codebook_grad_pallas(jnp.asarray(g), jnp.asarray(idx), 16, tile=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), **TOL)


def test_wrappers_on_cpu_run_the_plain_versions():
    x, cb = _inputs(64, 64, 32, seed=6)
    flat, tcb = torch.from_numpy(x.reshape(-1, 64)), torch.from_numpy(cb)
    before = launch_count(vq_fused_fwd), launch_count(vq_codebook_grad)
    for a, b in zip(vq_fused_fwd(flat, tcb), vq_fused_fwd_ref(flat, tcb)):
        assert torch.equal(a, b)
    idx = vq_fused_fwd(flat, tcb)[1]
    assert torch.equal(vq_codebook_grad(flat, idx, 32), vq_codebook_grad_ref(flat, idx, 32))
    assert (launch_count(vq_fused_fwd), launch_count(vq_codebook_grad)) == before


def test_wrappers_reject_a_device_they_have_no_path_for():
    with pytest.raises(ValueError, match="cpu or cuda"):
        vq_fused_fwd(torch.empty((4, 64), device="meta"), torch.empty((8, 64), device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        vq_codebook_grad(torch.empty((4, 64), device="meta"),
                         torch.empty((4,), dtype=torch.int32, device="meta"), 8)


def test_use_pallas_false_takes_the_lookup_path():
    """use_pallas keeps the JAX meaning: False is the lookup path, whose STE
    output is x + (q − x) (rounded), and whose losses match the fused path."""
    x, cb = _inputs(64, 8, 16, seed=7)
    fused = vector_quantize(torch.from_numpy(x), torch.from_numpy(cb), BETA)
    lookup = vector_quantize(torch.from_numpy(x), torch.from_numpy(cb), BETA, use_pallas=False)
    assert torch.equal(fused.encoding_indices, lookup.encoding_indices)
    assert torch.equal(fused.quantized, lookup.quantized)
    for name in ("embedding_loss", "commitment_loss", "perplexity"):
        torch.testing.assert_close(getattr(fused, name), getattr(lookup, name), rtol=1e-5,
                                   atol=0)
