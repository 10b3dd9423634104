"""VQVAENet(compute_dtype="bfloat16") on the CPU against the JAX package's bf16
VQVAENet on the same fp32 weights (``vqvae_state_dict_from_jax``): the
forward, ``get_quantized`` and ``decode``. The two compute the same casts but
not the same function: the port's stems are the Pallas kernel's (fp32 bias
before the bf16 rounding) where JAX's default XLA stems add a bf16 bias, and
the two frameworks' CPU convs sum in other orders before they round to bf16.
Measured on these inputs: output and decode within 0.62 % of their scale,
latents within 1.04 bf16 ulps of theirs, losses within 1.6e-4 relative, every
code id equal. Held to 0.02·scale (JAX's own bf16 test allows 0.08·scale
against fp32), latents to 4 ulps of their scale (2⁻⁶), ids at ≥ 95 % equal
(its own limit) and losses at rtol 1e-3. Parameters stay fp32 and the outputs
are fp32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msla_tpu.nn.vqvae_net import VQVAENet as JaxVQVAENet
from msla_tpu_torch.nn.vqvae_net import VQVAENet
from msla_tpu_torch.utils.jax_compat import vqvae_state_dict_from_jax

CFG = dict(num_hidden=32, num_residual_layer=2, num_residual_hidden=16, num_embedding=32,
           embedding_dim=16, commitment_cost=0.25)
OUT_TOL = 0.02


@pytest.fixture(scope="module")
def nets():
    x = (np.random.default_rng(0).standard_normal((2, 4, 1024)) * 0.3).astype(np.float32)
    jax_net = JaxVQVAENet(**CFG, use_pallas=False, compute_dtype="bfloat16")
    params = jax_net.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    net = VQVAENet(**CFG, compute_dtype="bfloat16", device="cpu")
    net.load_state_dict(vqvae_state_dict_from_jax(params, CFG["num_residual_layer"]))
    return x, jax_net, params, net


def _scale(a) -> float:
    return float(np.abs(np.asarray(a)).max())


def test_bf16_forward_matches_jax(nets):
    x, jax_net, params, net = nets
    want = jax_net.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got.output.dtype == torch.float32 and got.output.shape == (2, 4, 1024)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    scale = _scale(want.output)
    assert np.abs(got.output.numpy() - np.asarray(want.output)).max() <= OUT_TOL * scale
    for name in ("embedding_loss", "commitment_loss", "perplexity"):
        np.testing.assert_allclose(getattr(got, name).item(), float(getattr(want, name)),
                                   rtol=1e-3, err_msg=name)


def test_bf16_latents_and_codes_match_jax(nets):
    x, jax_net, params, net = nets
    want_z = np.asarray(jax_net.apply({"params": params}, jnp.asarray(x),
                                      method=JaxVQVAENet.encode))
    want_q = jax_net.apply({"params": params}, jnp.asarray(x),
                           method=JaxVQVAENet.get_quantized)
    with torch.no_grad():
        z = net.encode(torch.from_numpy(x))
        q = net.get_quantized(torch.from_numpy(x))
    assert z.dtype == q.quantized.dtype == torch.float32
    assert np.abs(z.numpy() - want_z).max() <= 2.0 ** -6 * _scale(want_z)
    ids, want_ids = q.encoding_indices.numpy(), np.asarray(want_q.encoding_indices)
    assert (ids == want_ids).mean() >= 0.95
    same = ids == want_ids
    np.testing.assert_allclose(q.quantized.numpy().transpose(0, 2, 1)[same],  # z + (e - z)
                               np.asarray(want_q.quantized).transpose(0, 2, 1)[same],
                               rtol=0, atol=1e-6)


def test_bf16_decode_matches_jax(nets):
    x, jax_net, params, net = nets
    q = np.random.default_rng(1).standard_normal((2, CFG["embedding_dim"], 256)) \
        .astype(np.float32)
    want = np.asarray(jax_net.apply({"params": params}, jnp.asarray(q),
                                    method=JaxVQVAENet.decode))
    with torch.no_grad():
        got = net.decode(torch.from_numpy(q))
    assert got.dtype == torch.float32 and got.shape == (2, 4, 1024)
    assert np.abs(got.numpy() - want).max() <= OUT_TOL * _scale(want)


def test_bf16_is_not_the_fp32_network(nets):
    """The mode is really bf16: the same weights in fp32 give other values,
    within JAX's own bf16-against-fp32 bound."""
    x, _, _, net = nets
    fp32 = VQVAENet(**CFG, device="cpu")
    fp32.load_state_dict(net.state_dict())
    with torch.no_grad():
        a, b = net(torch.from_numpy(x)).output, fp32(torch.from_numpy(x)).output
    err = (a - b).abs().max().item()
    assert 0 < err <= 0.08 * b.abs().max().item()


@pytest.mark.parametrize("compute_dtype", ["float16", "bf16"])
def test_other_compute_dtypes_are_refused(compute_dtype):
    with pytest.raises(ValueError, match="compute_dtype"):
        VQVAENet(**CFG, compute_dtype=compute_dtype, device="cpu")
