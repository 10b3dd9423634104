"""The VQ-VAE's kernels at widths past configs/hparams_search/optuna.yaml's, on
the CPU, against the JAX package.

* the plain stems (K1/K1b, K2/K2b) at num_hidden 6, 7 and 96 against the
  Pallas stems in interpret mode, output and hidden, atol = rtol = 1e-5;
* the plain search, fused forward and codebook gradient (K3, #4, #5) at
  (D, K) = (8, 1,024), (64, 1,024), (96, 33) and (512, 3) against the Pallas
  kernels in interpret mode: ids and q bit-equal, counts equal, sq and the
  gradient at 1e-5;
* the padding the any-width kernels run (``csrc/stem_any.cu``,
  ``csrc/vq_any.cu``, #5's column slices) through the plain versions: zero
  channels and columns, codes at ‖e‖² = +inf, against the unpadded
  operands;
* ``plan_stem``, ``plan_search`` and ``plan_grad`` over every width in range:
  a kernel for each, its block within SMEM_BYTES, its padding within the
  mma's granule, and ``ValueError`` naming the width one past each limit;
* ``VQVAENet`` at num_hidden 96, D 8, K 1,024 against the JAX net on the
  same weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_layout import ncw, t32, torch_weight
from msla_tpu.nn.vqvae_net import VQVAENet as JaxVQVAENet
from msla_tpu.ops import vq_fused as jax_vq_fused
from msla_tpu.ops.conv_stem import conv_stem_pallas
from msla_tpu.ops.deconv_stem import deconv_stem_pallas
from msla_tpu.ops.vq_pallas import nearest_codes_pallas
from msla_tpu_torch.nn.vqvae_net import VQVAENet
from msla_tpu_torch.ops import segment_sum
from msla_tpu_torch.ops._build import SIGNATURES, SMEM_BYTES
from msla_tpu_torch.ops.conv_stem import (GRANULE, M_GRANULE, MAX_C1, MAX_C2, conv_stem_ref,
                                          plan_stem)
from msla_tpu_torch.ops.deconv_stem import MAX_C, deconv_stem_ref
from msla_tpu_torch.ops.deconv_stem import plan_stem as plan_deconv
from msla_tpu_torch.ops.nearest_codes import (ANY_GRANULE, MAX_D, MAX_K, code_norms,
                                              nearest_codes_ref, plan_search, tuned_takes)
from msla_tpu_torch.ops.vq_fused import (GRAD_RUN, grad_smem_bytes, plan_grad,
                                         vq_codebook_grad_ref, vq_fused_fwd_ref)
from msla_tpu_torch.utils.jax_compat import vqvae_state_dict_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
HIDDEN = (6, 7, 96)
CODES = ((8, 1024), (64, 1024), (96, 33), (512, 3))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the whole run's workers share the host's cores,
    and torch's threads, each worker's as many as the cores, contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stem_inputs(t, c1, c2, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, t, 4)).astype(np.float32),
            (rng.standard_normal((4, 4, c1)) * 0.2).astype(np.float32),
            (rng.standard_normal((c1,)) * 0.1).astype(np.float32),
            (rng.standard_normal((4, c1, c2)) * (0.5 / np.sqrt(c1))).astype(np.float32),
            (rng.standard_normal((c2,)) * 0.1).astype(np.float32))


def _deconv_inputs(w, c, c1, seed):
    rng = np.random.default_rng(seed)
    return (np.abs(rng.standard_normal((2, w, c))).astype(np.float32),
            (rng.standard_normal((4, c1, c)) * (0.5 / np.sqrt(c))).astype(np.float32),
            (rng.standard_normal((c1,)) * 0.1).astype(np.float32),
            (rng.standard_normal((4, 4, c1)) * (0.5 / np.sqrt(c1))).astype(np.float32),
            (rng.standard_normal((4,)) * 0.1).astype(np.float32))


def _port(x, w1, b1, w2, b2):
    return ncw(x), torch_weight(w1), t32(b1), torch_weight(w2), t32(b2)


@pytest.mark.parametrize("hidden", HIDDEN)
def test_encoder_stem_matches_jax_pallas_at_any_width(hidden):
    args = _stem_inputs(96, hidden // 2, hidden, seed=hidden)
    want, want_h = conv_stem_pallas(*args, save_hidden=True, tile_w=8, interpret=True)
    got, h1 = conv_stem_ref(*_port(*args))
    assert got.shape == (2, hidden, 24) and h1.shape == (2, hidden // 2, 48)
    np.testing.assert_allclose(got.numpy(), ncw(want).numpy(), **TOL)
    np.testing.assert_allclose(h1.numpy(), ncw(want_h).numpy(), **TOL)


@pytest.mark.parametrize("hidden", HIDDEN)
def test_decoder_stem_matches_jax_pallas_at_any_width(hidden):
    args = _deconv_inputs(24, hidden, hidden // 2, seed=hidden + 1)
    want, want_h = deconv_stem_pallas(*args, save_hidden=True, tile_w=8, interpret=True)
    got, h = deconv_stem_ref(*_port(*args))
    assert got.shape == (2, 4, 96) and h.shape == (2, hidden // 2, 48)
    np.testing.assert_allclose(got.numpy(), ncw(want).numpy(), **TOL)
    np.testing.assert_allclose(h.numpy(), ncw(want_h).numpy(), **TOL)


@pytest.mark.parametrize("d,k", CODES)
def test_vq_fields_and_codebook_grad_match_jax_pallas_at_any_width(d, k):
    rng = np.random.default_rng(d + k)
    flat = rng.standard_normal((200, d)).astype(np.float32)
    cb = rng.standard_normal((k, d)).astype(np.float32)
    ids = nearest_codes_pallas(jnp.asarray(flat), jnp.asarray(cb), interpret=True)
    want = jax_vq_fused.vq_fused_fwd_pallas(jnp.asarray(flat), jnp.asarray(cb), tile=64,
                                            interpret=True)
    q, idx, counts, sq = vq_fused_fwd_ref(torch.from_numpy(flat), torch.from_numpy(cb))
    np.testing.assert_array_equal(nearest_codes_ref(torch.from_numpy(flat),
                                                    torch.from_numpy(cb)).numpy(),
                                  np.asarray(ids))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[1]).reshape(-1))
    np.testing.assert_array_equal(q.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(float(sq), float(want[3]), rtol=1e-5)
    g = rng.standard_normal((200, d)).astype(np.float32)
    dcb = vq_codebook_grad_ref(torch.from_numpy(g), idx, k)
    kernel = jax_vq_fused.vq_codebook_grad_pallas(jnp.asarray(g), jnp.asarray(idx.numpy()), k,
                                                  tile=64, interpret=True)
    np.testing.assert_allclose(dcb.numpy(), np.asarray(kernel), **TOL)
    # #5 over runs of GRAD_RUN codes a launch keeps each code's order
    blocks = 8
    runs = [segment_sum.codebook_grad_order_ref(torch.from_numpy(g), idx - k0,
                                                min(GRAD_RUN, k - k0), blocks)
            for k0 in range(0, k, GRAD_RUN)]
    assert torch.equal(torch.cat(runs),
                       segment_sum.codebook_grad_order_ref(torch.from_numpy(g), idx, k, blocks))


@pytest.mark.parametrize("hidden", (7, 96))
def test_padded_stem_channels_add_exact_zeros(hidden):
    """The any-width stems run C1 and C2 padded to the granule with zero
    weights and biases: the plain stems on padded operands, sliced to the
    true channels, equal the unpadded ones (within 1e-6), and the padded
    channels of the hidden and the output are exact zeros (ReLU(0))."""
    c1, c2 = hidden // 2, hidden
    c1p, c2p = plan_stem(c1, c2).padded
    x, w1, b1, w2, b2 = _port(*_stem_inputs(64, c1, c2, seed=3))
    padded = (x, F.pad(w1, (0, 0, 0, 0, 0, c1p - c1)), F.pad(b1, (0, c1p - c1)),
              F.pad(w2, (0, 0, 0, c1p - c1, 0, c2p - c2)), F.pad(b2, (0, c2p - c2)))
    out, h = conv_stem_ref(x, w1, b1, w2, b2)
    out_p, h_p = conv_stem_ref(*padded)
    torch.testing.assert_close(out_p[:, :c2], out, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(h_p[:, :c1], h, rtol=1e-6, atol=1e-6)
    assert not out_p[:, c2:].any() and not h_p[:, c1:].any()

    cp, c1p = plan_deconv(c2, c1).padded
    q, w1, b1, w2, b2 = _port(*_deconv_inputs(16, c2, c1, seed=4))
    padded = (F.pad(q, (0, 0, 0, cp - c2)), F.pad(w1, (0, 0, 0, c1p - c1, 0, cp - c2)),
              F.pad(b1, (0, c1p - c1)), F.pad(w2, (0, 0, 0, 0, 0, c1p - c1)), b2)
    out, h = deconv_stem_ref(q, w1, b1, w2, b2)
    out_p, h_p = deconv_stem_ref(*padded)
    torch.testing.assert_close(out_p, out, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(h_p[:, :c1], h, rtol=1e-6, atol=1e-6)
    assert not h_p[:, c1:].any()


@pytest.mark.parametrize("d,k", ((7, 33), (96, 33), (1, 5)))
def test_padded_codes_and_columns_leave_the_search_and_gradient_alone(d, k):
    """The any-width search runs D padded to its k8 step with zero columns
    and the last chunk's codes past K at ‖e‖² = +inf; #5 reads rows padded
    to 4 columns: the distances on padded operands pick the same ids bit for
    bit, never a planted +inf code (even one equal to a row), and the
    gradient's order on padded columns, sliced, is the unpadded one's."""
    g = torch.Generator().manual_seed(d * 100 + k)
    x = torch.randn((300, d), generator=g)
    cb = torch.randn((k, d), generator=g)
    dp, kp = plan_search(k, d).padded
    xp = F.pad(x, (0, dp - d))
    cbp = F.pad(cb, (0, dp - d, 0, kp - k + 8))
    cbp[k] = xp[0]                                         # a code at x[0] itself
    e2 = torch.cat([code_norms(cb), torch.full((kp - k + 8,), float("inf"))])
    ids = torch.argmin(e2 - 2.0 * (xp @ cbp.T), dim=1)
    want = nearest_codes_ref(x, cb)
    assert torch.equal(ids.to(torch.int32), want)
    assert int(ids.max()) < k
    q, _, counts, sq = vq_fused_fwd_ref(x, cb)
    qp = cbp.index_select(0, ids)
    assert torch.equal(qp[:, :d], q) and not qp[:, d:].any()
    torch.testing.assert_close(((qp - xp) ** 2).sum(), sq, rtol=1e-6, atol=1e-6)

    width = plan_grad(k, d).width
    grad = torch.randn((300, d), generator=g)
    padded = segment_sum.codebook_grad_order_ref(F.pad(grad, (0, width - d)), want, k, 8)
    assert torch.equal(padded[:, :d], segment_sum.codebook_grad_order_ref(grad, want, k, 8))
    assert not padded[:, d:].any()


def test_every_stem_width_in_range_has_a_kernel_and_one_past_is_refused():
    for dtype, granule in GRANULE.items():
        for hidden in range(2, MAX_C2 + 1):
            c1, c2 = hidden // 2, hidden
            for plan, (w1, w2) in ((plan_stem(c1, c2, dtype), (c1, c2)),
                                   (plan_deconv(c2, c1, dtype), (c2, c1))):
                assert plan.symbol in SIGNATURES
                if plan.smem is not None:  # an any-width kernel's block
                    assert plan.smem <= SMEM_BYTES
                    assert plan.tile in (16, 32, 64, 128)
                pa, pb = plan.padded
                if plan.symbol == "conv_stem_any_fwd":
                    assert 0 <= pa - w1 < granule and 0 <= pb - w2 < M_GRANULE
                elif plan.symbol == "deconv_stem_any_fwd":
                    assert 0 <= pa - w1 < granule and 0 <= pb - w2 < granule
                else:  # a tuned kernel, at its own widths
                    assert (pa, pb) == (w1, w2)
                assert 0.0 <= plan.padded_share < 1.0
    for c1, c2 in ((MAX_C1 + 1, MAX_C2), (MAX_C1, MAX_C2 + 1), (0, 2)):
        with pytest.raises(ValueError, match=rf"\(C1, C2\) = \({c1}, {c2}\)"):
            plan_stem(c1, c2)
    for c, c1 in ((MAX_C + 1, 256), (512, MAX_C1 + 1)):
        with pytest.raises(ValueError, match=rf"\(C, C1\) = \({c}, {c1}\)"):
            plan_deconv(c, c1, torch.bfloat16)


def _check_search(k, d, with_hist):
    plan = plan_search(k, d, with_hist)
    dp, kp = plan.padded
    assert plan.smem <= SMEM_BYTES
    if plan.design == "any width":
        assert not tuned_takes(k, d, with_hist)
        assert 0 <= dp - d < ANY_GRANULE and 0 <= kp - k < ANY_GRANULE
        assert dp <= {128: 128, 64: 256, 32: 512}[plan.rows]
    else:
        assert tuned_takes(k, d, with_hist) and dp == d


def test_every_search_and_gradient_width_in_range_has_a_kernel_and_one_past_is_refused():
    ks = sorted({1, 2, 3, 31, 32, 33, 511, 512, 513, 608, 610, 640, 642, 701, 702, 1024, 2048,
                 8344, 8346, 24_744, 24_746, MAX_K - 1, MAX_K})
    for d in range(1, MAX_D + 1):
        for k in ks:
            for with_hist in (False, True):
                _check_search(k, d, with_hist)
    for d in (1, 8, 64, 96, 128, 256, 512):     # every K at the widths where designs switch
        for k in range(1, MAX_K + 1, 1 if d in (64, 128, 256) else 7):
            _check_search(k, d, True)
    for d in range(1, MAX_D + 1, 5):
        for k in (1, 700, 701, 702, 4096, MAX_K):
            plan = plan_grad(k, d)
            assert plan.run <= GRAD_RUN and grad_smem_bytes(plan.run) <= SMEM_BYTES
            assert plan.runs * plan.run >= k > (plan.runs - 1) * plan.run
            assert 0 <= plan.width - d < 4 and plan.slices * segment_sum.SLICE >= plan.width
    for fn in (lambda k, d: plan_search(k, d), lambda k, d: plan_search(k, d, True),
               plan_grad):
        with pytest.raises(ValueError, match=f"D={MAX_D + 1}"):
            fn(512, MAX_D + 1)
        with pytest.raises(ValueError, match=f"K={MAX_K + 1}"):
            fn(MAX_K + 1, 64)
        with pytest.raises(ValueError, match="D=0"):
            fn(512, 0)


def test_vqvae_net_matches_jax_at_96_8_1024():
    cfg = dict(num_hidden=96, num_residual_layer=1, num_residual_hidden=8, num_embedding=1024,
               embedding_dim=8, commitment_cost=0.25)
    t = 400
    jax_net = JaxVQVAENet(**cfg)
    params = jax.jit(jax_net.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4, 16)))["params"]
    net = VQVAENet(**cfg, device="cpu")
    net.load_state_dict(vqvae_state_dict_from_jax(params, cfg["num_residual_layer"]),
                        strict=True)
    x = np.random.default_rng(5).standard_normal((2, 4, t)).astype(np.float32)
    want = jax_net.apply({"params": params}, jnp.asarray(x), method=JaxVQVAENet.get_quantized)
    want_out = jax_net.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = net.get_quantized(torch.from_numpy(x))
        out = net(torch.from_numpy(x))
    np.testing.assert_array_equal(got.encoding_indices.numpy(),
                                  np.asarray(want.encoding_indices))
    np.testing.assert_allclose(got.quantized.numpy(), np.asarray(want.quantized),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.output.numpy(), np.asarray(want_out.output), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(out.commitment_loss), float(want_out.commitment_loss),
                               rtol=1e-5)
