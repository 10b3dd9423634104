"""msla_tpu_torch.ops.mlm_argmax on the CPU against the JAX package: the plain
version against ``mlm_argmax_pallas`` in interpret mode and against the jnp
path, both variants, at vocab sizes that are no multiple of 128, and planted
ties, where the lowest index must win. Ids bit-equal; confidences at rtol 1e-5
(a logsumexp over a few hundred terms in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msla_tpu.ops.mlm_argmax import _mlm_argmax_jnp, mlm_argmax_pallas
from msla_tpu_torch.ops.mlm_argmax import mlm_argmax, mlm_argmax_conf, mlm_argmax_ref

CONF_TOL = dict(rtol=1e-5, atol=1e-7)


def _rand(m, k, v, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((v, k)).astype(np.float32),
            rng.standard_normal((v,)).astype(np.float32))


@pytest.mark.parametrize("m,k,v", [(50, 16, 300), (24, 8, 130), (64, 32, 1000)])
@pytest.mark.parametrize("with_conf", [False, True])
def test_plain_matches_jax_pallas_interpret(m, k, v, with_conf):
    h, emb, bias = _rand(m, k, v, seed=m)
    want = mlm_argmax_pallas(jnp.asarray(h), jnp.asarray(emb), jnp.asarray(bias),
                             with_conf=with_conf, tile_m=16, tile_v=128, interpret=True)
    got = mlm_argmax_ref(torch.from_numpy(h), torch.from_numpy(emb), torch.from_numpy(bias),
                         with_conf=with_conf)
    if with_conf:
        (want, want_conf), (got, got_conf) = want, got
        np.testing.assert_allclose(got_conf.numpy(), np.asarray(want_conf), **CONF_TOL)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("with_conf", [False, True])
def test_wrapper_matches_jax_jnp_path(with_conf):
    """``mlm_argmax`` keeps h's leading shape, as the JAX dispatcher does, and
    on CPU tensors runs the plain version without counting a launch."""
    h, emb, bias = _rand(6 * 5, 8, 40, seed=2)
    want = _mlm_argmax_jnp(jnp.asarray(h), jnp.asarray(emb), jnp.asarray(bias), with_conf)
    before = (mlm_argmax.launches, mlm_argmax_conf.launches)
    got = mlm_argmax(torch.from_numpy(h).reshape(6, 5, 8), torch.from_numpy(emb),
                     torch.from_numpy(bias), with_conf=with_conf)
    assert (mlm_argmax.launches, mlm_argmax_conf.launches) == before
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
