"""msla_tpu_torch.ops.mlm_argmax on the CPU against the JAX package: the plain
version against ``mlm_argmax_pallas`` in interpret mode and against the jnp
path, both variants, at vocab sizes that are no multiple of 128, and planted
ties, where the lowest index must win. Ids bit-equal; confidences at rtol 1e-5
(a logsumexp over a few hundred terms in another order).

The CUDA kernel computes the logits in 3xTF32; its CPU emulation
(``mlm_logits_3xtf32_ref``) is held here to fp64 and to JAX's argmax, and
planted pairs 1e-4 apart show that it resolves what one TF32 pass cannot."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msla_tpu.ops.mlm_argmax import _mlm_argmax_jnp, mlm_argmax_pallas
from msla_tpu_torch.ops._build import launch_count
from msla_tpu_torch.ops.mlm_argmax import (mlm_argmax, mlm_argmax_conf, mlm_argmax_ref,
                                           mlm_logits_3xtf32_ref)
from msla_tpu_torch.ops.tf32 import tf32_round_ref

CONF_TOL = dict(rtol=1e-5, atol=1e-7)


def _rand(m, k, v, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((v, k)).astype(np.float32),
            rng.standard_normal((v,)).astype(np.float32))


def _conf_fp64(h, emb, bias):
    """exp(max − logsumexp) of each row's logits, in fp64."""
    logits = h.astype(np.float64) @ emb.T.astype(np.float64) + bias
    top = logits.max(1)
    return np.exp(top - (np.log(np.exp(logits - top[:, None]).sum(1)) + top))


@pytest.mark.parametrize("m,k,v", [(50, 16, 300), (24, 8, 130), (64, 32, 1000)])
@pytest.mark.parametrize("with_conf", [False, True])
def test_plain_matches_jax_pallas_interpret(m, k, v, with_conf):
    """With the confidences, each side is first held to fp64 at CONF_TOL, so
    that a failure names the side that moved."""
    h, emb, bias = _rand(m, k, v, seed=m)
    want = mlm_argmax_pallas(jnp.asarray(h), jnp.asarray(emb), jnp.asarray(bias),
                             with_conf=with_conf, tile_m=16, tile_v=128, interpret=True)
    got = mlm_argmax_ref(torch.from_numpy(h), torch.from_numpy(emb), torch.from_numpy(bias),
                         with_conf=with_conf)
    if with_conf:
        (want, want_conf), (got, got_conf) = want, got
        exact = _conf_fp64(h, emb, bias)
        for side, conf in (("the port's plain version", got_conf.numpy()),
                           ("the JAX Pallas kernel", np.asarray(want_conf))):
            np.testing.assert_allclose(conf, exact, **CONF_TOL,
                                       err_msg=f"{side}'s conf against fp64")
        np.testing.assert_allclose(got_conf.numpy(), np.asarray(want_conf), **CONF_TOL)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("with_conf", [False, True])
def test_wrapper_matches_jax_jnp_path(with_conf):
    """``mlm_argmax`` keeps h's leading shape, as the JAX dispatcher does, and
    on CPU tensors runs the plain version without counting a launch."""
    h, emb, bias = _rand(6 * 5, 8, 40, seed=2)
    want = _mlm_argmax_jnp(jnp.asarray(h), jnp.asarray(emb), jnp.asarray(bias), with_conf)
    before = (launch_count(mlm_argmax), launch_count(mlm_argmax_conf))
    got = mlm_argmax(torch.from_numpy(h).reshape(6, 5, 8), torch.from_numpy(emb),
                     torch.from_numpy(bias), with_conf=with_conf)
    assert (launch_count(mlm_argmax), launch_count(mlm_argmax_conf)) == before
    if with_conf:
        (want, want_conf), (got, got_conf) = want, got
        assert got_conf.shape == (6, 5)
        np.testing.assert_allclose(got_conf.numpy().reshape(-1), np.asarray(want_conf),
                                   **CONF_TOL)
    assert got.shape == (6, 5) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().reshape(-1), np.asarray(want))


@pytest.mark.parametrize("with_conf", [False, True])
def test_planted_ties_pick_the_lowest_index(with_conf):
    """Rows 7, 40, 85 and 299 of emb are equal and maximal for every h row:
    the lowest, 7, wins in both packages (ties inside and across tiles)."""
    k, v = 4, 300
    h = np.ones((8, k), np.float32)
    emb = np.zeros((v, k), np.float32)
    emb[[7, 40, 85, 299]] = 1.0
    bias = np.zeros((v,), np.float32)
    want = mlm_argmax_pallas(jnp.asarray(h), jnp.asarray(emb), jnp.asarray(bias),
                             with_conf=with_conf, tile_m=8, tile_v=32, interpret=True)
    got = mlm_argmax(torch.from_numpy(h), torch.from_numpy(emb), torch.from_numpy(bias),
                     with_conf=with_conf)
    if with_conf:
        (want, want_conf), (got, got_conf) = want, got
        np.testing.assert_allclose(got_conf.numpy(), np.asarray(want_conf), **CONF_TOL)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got == 7).all()


def test_plain_version_chunks_rows():
    """The plain version takes its rows in chunks; the chunking does not show."""
    h, emb, bias = _rand(5000, 8, 50, seed=4)
    th, te, tb = map(torch.from_numpy, (h, emb, bias))
    ids, conf = mlm_argmax_ref(th, te, tb, with_conf=True)
    logits = th @ te.T + tb
    assert torch.equal(ids, torch.argmax(logits, dim=-1).to(torch.int32))
    torch.testing.assert_close(conf, torch.softmax(logits, -1).max(-1).values)


def _tf32_logits(h, emb, bias):
    """One TF32 pass: both operands rounded to TF32, exact fp32 products."""
    return tf32_round_ref(h) @ tf32_round_ref(emb).T + bias


def test_tf32_round_is_round_to_nearest_ties_away():
    """cvt.rna.tf32.f32's rounding: 10 mantissa bits, a tie goes away from 0."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + 1.5 * ulp, 1 + ulp / 2 - 2 ** -23,
                      3.0, 0.0, -0.0, float("inf")], dtype=torch.float32)
    want = [1 + ulp, -(1 + ulp), 1 + 2 * ulp, 1.0, 3.0, 0.0, -0.0, float("inf")]
    assert tf32_round_ref(x).tolist() == want
    r = tf32_round_ref(torch.from_numpy(np.random.default_rng(0).standard_normal(1000)
                                        .astype(np.float32)))
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()


@pytest.mark.parametrize("m,k,v", [(50, 16, 300), (24, 8, 130), (64, 32, 1000), (30, 8, 40),
                                   (16, 768, 300)])
def test_3xtf32_argmax_matches_jax(m, k, v):
    """The kernel's arithmetic, emulated, picks JAX's ids on the plain tests' inputs."""
    h, emb, bias = _rand(m, k, v, seed=m)
    want = _mlm_argmax_jnp(jnp.asarray(h), jnp.asarray(emb), jnp.asarray(bias), False)
    logits = mlm_logits_3xtf32_ref(*map(torch.from_numpy, (h, emb, bias)))
    np.testing.assert_array_equal(torch.argmax(logits, -1).numpy(), np.asarray(want))


def test_3xtf32_argmax_planted_ties_pick_the_lowest_index():
    k, v = 4, 300
    h = np.ones((8, k), np.float32)
    emb = np.zeros((v, k), np.float32)
    emb[[7, 40, 85, 299]] = 1.0
    bias = np.zeros((v,), np.float32)
    want = _mlm_argmax_jnp(jnp.asarray(h), jnp.asarray(emb), jnp.asarray(bias), False)
    logits = mlm_logits_3xtf32_ref(*map(torch.from_numpy, (h, emb, bias)))
    got = torch.argmax(logits, -1).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got == 7).all()


@pytest.mark.parametrize("m,k,v,emb_scale", [(50, 16, 300, 1.0), (64, 32, 1000, 1.0),
                                             (64, 768, 500, 1.0), (64, 768, 500, 0.02),
                                             (64, 64, 1000, 0.02)])
def test_3xtf32_logits_are_fp32_faithful(m, k, v, emb_scale):
    """Within 1e-6·(Σ_k |h_k·E_vk| + |b_v| + 1) of fp64, the size of fp32's own
    error; at bert-base init scale (E ~ 0.02·N(0, 1), b ~ 0.1·N(0, 1)) that
    is within 1e-6·(|logit| + 1). One TF32 pass misses both by 50× or more.
    (With E ~ N(0, 1) a plain fp32 product itself is off by up to 1.7e-6 of
    |logit| + 1 where terms cancel, so the bound there is on the terms.)"""
    rng = np.random.default_rng(m + k)
    h = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    emb = torch.from_numpy((emb_scale * rng.standard_normal((v, k))).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.standard_normal(v)).astype(np.float32))
    exact = h.double() @ emb.double().T + bias.double()
    terms = h.double().abs() @ emb.double().abs().T + bias.double().abs() + 1
    limit = 1e-6 * (exact.abs() + 1 if emb_scale < 1 else terms)
    err = (mlm_logits_3xtf32_ref(h, emb, bias).double() - exact).abs()
    assert (err <= limit).all(), (err / limit).max().item()
    assert ((_tf32_logits(h, emb, bias).double() - exact).abs() / limit).max() > 50


def _close_pairs(h, v, lo, hi, rel_gap=1e-4):
    """emb and bias where row r's logit at vocab row hi[r] exceeds the one at
    lo[r] < hi[r] by rel_gap of itself (fp64), far above every other logit.
    E[lo] = tf32(3·h/|h|) and E[hi] = E[lo] + δ, with each |δ_k| under half a
    TF32 ulp of E[lo]_k: one TF32 pass sees two equal rows and picks lo."""
    v_planted = tf32_round_ref(3 * h / h.norm(dim=1, keepdim=True))
    _, expo = torch.frexp(v_planted)
    ulp = torch.ldexp(torch.ones_like(v_planted), expo - 11)  # of a 10-bit mantissa
    step = torch.sign(h) * ulp
    base = (h.double() * v_planted.double()).sum(1)
    scale = rel_gap * base / (h.double() * step.double()).sum(1)
    assert (scale < 0.5).all()
    emb = np.random.default_rng(1).standard_normal((v, h.shape[1])).astype(np.float32) * 0.02
    emb = torch.from_numpy(emb)
    emb[lo] = v_planted
    emb[hi] = v_planted + (scale[:, None] * step.double()).float()
    return emb, torch.zeros(v)


def test_planted_close_pairs_need_3xtf32():
    """Pairs 1e-4 apart (relative), in adjacent columns, 8, 64 and 256 apart
    and across the vocab: the 3xTF32 emulation picks the larger, as fp64 and
    JAX do; one TF32 pass ties them and picks the lower index."""
    rng = np.random.default_rng(3)
    n, k, v = 10, 32, 600
    h = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32))
    lo = torch.tensor([0, 6, 10, 100, 3, 257, 511, 40, 64, 2])
    hi = torch.tensor([1, 7, 18, 164, 259, 513, 599, 560, 320, 597])
    emb, bias = _close_pairs(h, v, lo, hi)
    exact = h.double() @ emb.double().T
    gap = (exact[torch.arange(n), hi] - exact[torch.arange(n), lo]) / exact[torch.arange(n), hi]
    np.testing.assert_allclose(gap.numpy(), 1e-4, rtol=1e-3)
    want = _mlm_argmax_jnp(jnp.asarray(h.numpy()), jnp.asarray(emb.numpy()),
                           jnp.asarray(bias.numpy()), False)
    np.testing.assert_array_equal(np.asarray(want), hi.numpy())
    assert torch.equal(torch.argmax(exact, -1), hi)
    assert torch.equal(torch.argmax(mlm_logits_3xtf32_ref(h, emb, bias), -1), hi)
    assert torch.equal(torch.argmax(_tf32_logits(h, emb, bias), -1), lo)
