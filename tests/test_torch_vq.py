"""msla_tpu_torch.ops.{nearest_codes,vq} on the CPU against the JAX package:
the nearest-code kernel in interpret mode (ids bit-equal) and the jnp VQ
forward against the port's lookup path (losses and perplexity at 1e-6)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msla_tpu.ops.vq import _vector_quantize_jnp
from msla_tpu.ops.vq_pallas import nearest_codes_pallas
from msla_tpu_torch.ops._build import launch_count
from msla_tpu_torch.ops.nearest_codes import nearest_codes, nearest_codes_ref
from msla_tpu_torch.ops.vq import code_usage_perplexity, vector_quantize


@pytest.mark.parametrize("n,d,k", [(1000, 64, 512), (7, 64, 512), (64, 8, 16)])
def test_plain_matches_jax_pallas_interpret(n, d, k):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, d)).astype(np.float32)
    cb = rng.standard_normal((k, d)).astype(np.float32)
    want = np.asarray(nearest_codes_pallas(jnp.asarray(x), jnp.asarray(cb), interpret=True))
    got = nearest_codes_ref(torch.from_numpy(x), torch.from_numpy(cb))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_all_equal_codes_tie_picks_index_0():
    cb = torch.ones((4, 8))
    x = torch.ones((16, 8))
    assert (nearest_codes(x, cb) == 0).all()


def test_wrapper_on_cpu_runs_the_plain_version():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((300, 64)).astype(np.float32))
    cb = torch.from_numpy(rng.standard_normal((512, 64)).astype(np.float32))
    before = launch_count(nearest_codes)
    assert torch.equal(nearest_codes(x, cb), nearest_codes_ref(x, cb))
    assert launch_count(nearest_codes) == before


def test_wrapper_rejects_a_device_it_has_no_path_for():
    with pytest.raises(ValueError, match="cpu or cuda"):
        nearest_codes(torch.empty((4, 64), device="meta"), torch.empty((8, 64), device="meta"))


@pytest.mark.parametrize("shape,k", [((2, 50, 8), 16), ((3, 40, 64), 512)])
def test_vector_quantize_matches_jnp(shape, k):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32)
    cb = (rng.uniform(-1, 1, (k, shape[-1])) * 0.5).astype(np.float32)
    want = _vector_quantize_jnp(jnp.asarray(x), jnp.asarray(cb), 0.25)
    got = vector_quantize(torch.from_numpy(x), torch.from_numpy(cb), 0.25, use_pallas=False)
    np.testing.assert_array_equal(got.encoding_indices.numpy(), np.asarray(want.encoding_indices))
    np.testing.assert_array_equal(got.quantized.numpy(), np.asarray(want.quantized))
    # x + (q - x) rounds as in JAX, not to q: bit-equal
    np.testing.assert_array_equal(got.quantized_ste.numpy(), np.asarray(want.quantized_ste))
    for name in ("embedding_loss", "commitment_loss", "perplexity"):
        np.testing.assert_allclose(float(getattr(got, name)), float(getattr(want, name)),
                                   rtol=1e-6, err_msg=name)


def test_perplexity_of_uniform_and_single_code_usage():
    k = 16
    uniform = torch.arange(4 * k, dtype=torch.int32) % k
    torch.testing.assert_close(code_usage_perplexity(uniform, k), torch.tensor(float(k)))
    torch.testing.assert_close(code_usage_perplexity(torch.zeros(10, dtype=torch.int32), k),
                               torch.tensor(1.0))
