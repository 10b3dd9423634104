"""msla_tpu_torch.ops.mlm_argmax's plain version on bf16 h and E (fp32 bias) on
the CPU against the JAX package's ``mlm_argmax_pallas`` in interpret mode and
its jnp path on the same bf16 operands, both variants, at vocab sizes that are
no multiple of 128: the logits are fp32 sums of the exact bf16 products in
both, so every id is equal or a near-tie (fp64 logit gap below
1e-5·(|logit| + 1)) and the confidences agree at rtol 1e-5. Planted equal
ties go to the lowest index."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msla_tpu.ops.mlm_argmax import _mlm_argmax_jnp, mlm_argmax_pallas
from msla_tpu_torch.ops.mlm_argmax import mlm_argmax, mlm_argmax_conf, mlm_argmax_ref

BF = torch.bfloat16
CONF_TOL = dict(rtol=1e-5, atol=1e-7)


def _rand(m, k, v, seed):
    """bf16 h and E (as torch tensors and the same values for JAX), fp32 bias."""
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(BF)
    emb = torch.from_numpy(rng.standard_normal((v, k)).astype(np.float32)).to(BF)
    bias = torch.from_numpy(rng.standard_normal((v,)).astype(np.float32))
    jax_args = (jnp.asarray(h.float().numpy(), jnp.bfloat16),
                jnp.asarray(emb.float().numpy(), jnp.bfloat16), jnp.asarray(bias.numpy()))
    return (h, emb, bias), jax_args


def assert_ids_equal_or_near_ties(got, want, h, emb, bias):
    rows = np.flatnonzero(got != want)
    if rows.size:
        e, b = emb.double().numpy(), bias.double().numpy()
        hs = h.double().numpy()[rows]
        la = (hs * e[got[rows]]).sum(1) + b[got[rows]]
        lb = (hs * e[want[rows]]).sum(1) + b[want[rows]]
        assert (np.abs(la - lb) < 1e-5 * (np.abs(lb) + 1)).all()


@pytest.mark.parametrize("m,k,v", [(50, 16, 300), (24, 8, 130), (64, 32, 1000)])
@pytest.mark.parametrize("with_conf", [False, True])
def test_bf16_plain_matches_jax_pallas_interpret(m, k, v, with_conf):
    port, jax_args = _rand(m, k, v, seed=m)
    want = mlm_argmax_pallas(*jax_args, with_conf=with_conf, tile_m=16, tile_v=128,
                             interpret=True)
    got = mlm_argmax_ref(*port, with_conf=with_conf)
    if with_conf:
        (want, want_conf), (got, got_conf) = want, got
        assert got_conf.dtype == torch.float32
        np.testing.assert_allclose(got_conf.numpy(), np.asarray(want_conf), **CONF_TOL)
    assert got.dtype == torch.int32
    assert_ids_equal_or_near_ties(got.numpy(), np.asarray(want), *port)


@pytest.mark.parametrize("with_conf", [False, True])
def test_bf16_wrapper_matches_jax_jnp_path(with_conf):
    port, jax_args = _rand(6 * 5, 8, 40, seed=2)
    want = _mlm_argmax_jnp(*jax_args, with_conf)
    h, emb, bias = port
    got = mlm_argmax(h.reshape(6, 5, 8), emb, bias, with_conf=with_conf)
    if with_conf:
        (want, want_conf), (got, got_conf) = want, got
        np.testing.assert_allclose(got_conf.numpy().reshape(-1), np.asarray(want_conf),
                                   **CONF_TOL)
    assert got.shape == (6, 5)
    assert_ids_equal_or_near_ties(got.numpy().reshape(-1), np.asarray(want), *port)


def test_bf16_planted_ties_go_to_the_lowest_index():
    (h, emb, bias), _ = _rand(40, 16, 500, seed=3)
    rows = torch.arange(40)
    lo, hi = 3 * rows + 7, 499 - rows
    emb[lo] = emb[hi] = (4 * h / h.float().norm(dim=1, keepdim=True)).to(BF)
    bias[lo] = bias[hi] = 0.0
    ids, conf = mlm_argmax_conf(h, emb, bias)
    assert torch.equal(ids.long(), lo)
    assert torch.equal(mlm_argmax(h, emb, bias).long(), lo)
    assert torch.equal(ids, mlm_argmax_ref(h, emb, bias))
    assert (conf <= 0.5).all()


def _plant(emb, bias, h, row, cols):
    """Make every vocab row of ``cols`` the same far-ahead logit for ``row``."""
    planted = (4 * h[row] / h[row].float().norm()).to(BF)
    for c in cols:
        emb[c] = planted
        bias[c] = 0.0


@pytest.mark.parametrize("m,k,v", [(50, 16, 300), (129, 32, 513), (7, 8, 100)])
@pytest.mark.parametrize("with_conf", [False, True])
def test_tiled_fold_matches_jax_pallas_interpret(m, k, v, with_conf):
    """The bf16 kernel's fold as it orders it (mlm_fold_tiled_ref: 256-wide
    vocab tiles, each quad thread's 64 columns folded in ascending order with
    a strict >, the quad combined by xor 1 then xor 2, the sums as powers of
    2) on the plain version's logits, against the JAX Pallas kernel in
    interpret mode: ids bit-equal, conf within rtol 1e-4. The cases have a
    last tile past V and row counts that are no multiple of 64, and planted
    ties between columns of different tiles, of different threads' slices
    of one tile and of one thread's slice: the lowest index wins."""
    from msla_tpu_torch.ops.mlm_argmax import mlm_fold_tiled_ref

    (h, emb, bias), _ = _rand(m, k, v, seed=m + v)
    ties = {0: (v - 1, 3), 1: (9, 10), 2: (12, 4), 3: (2, 258 % v, 66)}  # row: columns
    for row, cols in ties.items():
        _plant(emb, bias, h, row, cols)
    jax_args = (jnp.asarray(h.float().numpy(), jnp.bfloat16),
                jnp.asarray(emb.float().numpy(), jnp.bfloat16), jnp.asarray(bias.numpy()))
    want = mlm_argmax_pallas(*jax_args, with_conf=with_conf, tile_m=16, tile_v=128,
                             interpret=True)
    got = mlm_fold_tiled_ref(h.float() @ emb.float().T + bias, with_conf=with_conf)
    if with_conf:
        (want, want_conf), (got, got_conf) = want, got
        np.testing.assert_allclose(got_conf.numpy(), np.asarray(want_conf), rtol=1e-4, atol=0)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for row, cols in ties.items():
        assert got[row].item() == min(cols)
