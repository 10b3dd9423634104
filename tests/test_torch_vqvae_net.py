"""msla_tpu_torch.nn.VQVAENet on the CPU against msla_tpu.nn.VQVAENet on the
same weights (passed through vqvae_state_dict_from_jax). fp32 both; activations
at rtol 1e-4, atol 1e-5 (conv stacks summed in another order), code ids equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msla_tpu.nn.vqvae_net import VQVAENet as JaxVQVAENet
from msla_tpu.utils.torch_compat import vqvae_params_to_torch
from msla_tpu_torch.nn.vqvae_net import VQVAENet
from msla_tpu_torch.utils.jax_compat import vqvae_state_dict_from_jax

CFG = dict(num_hidden=16, num_residual_layer=2, num_residual_hidden=8, num_embedding=16,
           embedding_dim=8, commitment_cost=0.25)
T = 2000
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def nets():
    # fuse_stem left off: the JAX fused kernels only lower on a TPU here; the
    # XLA stems compute the same function (tests/test_conv_stem.py)
    jax_net = JaxVQVAENet(**CFG)
    params = jax_net.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, T)))["params"]
    net = VQVAENet(**CFG, device="cpu")
    net.load_state_dict(vqvae_state_dict_from_jax(params, CFG["num_residual_layer"]),
                        strict=True)
    return jax_net, params, net


def _x(seed=0, b=2):
    return np.random.default_rng(seed).standard_normal((b, 4, T)).astype(np.float32)


def _apply(jax_net, params, *args, method=None):
    return jax_net.apply({"params": params}, *args, method=method)


def test_encode(nets):
    jax_net, params, net = nets
    x = _x()
    want = np.asarray(_apply(jax_net, params, jnp.asarray(x), method=JaxVQVAENet.encode))
    with torch.no_grad():
        got = net.encode(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, T // 4, CFG["embedding_dim"])
    np.testing.assert_allclose(got, want, **TOL)


def test_get_quantized(nets):
    jax_net, params, net = nets
    x = _x(1)
    want = _apply(jax_net, params, jnp.asarray(x), method=JaxVQVAENet.get_quantized)
    with torch.no_grad():
        got = net.get_quantized(torch.from_numpy(x))
    np.testing.assert_array_equal(got.encoding_indices.numpy(),
                                  np.asarray(want.encoding_indices))
    np.testing.assert_allclose(got.quantized.numpy(), np.asarray(want.quantized), **TOL)
    np.testing.assert_allclose(float(got.perplexity), float(want.perplexity), rtol=1e-6)


def test_decode_and_decode_indices(nets):
    jax_net, params, net = nets
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, CFG["embedding_dim"], T // 4)).astype(np.float32)
    idx = rng.integers(0, CFG["num_embedding"], (2, T // 4)).astype(np.int32)
    want = np.asarray(_apply(jax_net, params, jnp.asarray(q), method=JaxVQVAENet.decode))
    want_i = np.asarray(_apply(jax_net, params, jnp.asarray(idx),
                               method=JaxVQVAENet.decode_indices))
    with torch.no_grad():
        got = net.decode(torch.from_numpy(q)).numpy()
        got_i = net.decode_indices(torch.from_numpy(idx)).numpy()
    assert got.shape == got_i.shape == (2, 4, T)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got_i, want_i, **TOL)


def test_forward_output_and_losses(nets):
    jax_net, params, net = nets
    x = _x(3)
    want = _apply(jax_net, params, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    np.testing.assert_allclose(got.output.numpy(), np.asarray(want.output), **TOL)
    for name in ("embedding_loss", "commitment_loss", "perplexity"):
        np.testing.assert_allclose(float(getattr(got, name)), float(getattr(want, name)),
                                   err_msg=name, **TOL)


def test_forward_under_grad_matches_jax(nets):
    """The forward under grad runs the training path (the stems' save-hidden
    forwards and custom backwards, the fused VQ) and its gradients match
    jax.grad of the same loss. Gradients at rtol 1e-4 and
    atol 1e-6 of the largest (sums over thousands of products in another
    order)."""
    jax_net, params, net = nets
    x = _x(4)
    w = np.random.default_rng(5).standard_normal((2, 4, T)).astype(np.float32)

    def jax_loss(p):
        out = _apply(jax_net, p, jnp.asarray(x))
        return jnp.sum(out.output * w) + out.embedding_loss + out.commitment_loss

    want = vqvae_state_dict_from_jax(jax.grad(jax_loss)(params), CFG["num_residual_layer"])
    net.zero_grad(set_to_none=True)
    out = net(torch.from_numpy(x))
    (torch.sum(out.output * torch.from_numpy(w)) + out.embedding_loss
     + out.commitment_loss).backward()
    for key, param in net.named_parameters():
        scale = want[key].abs().max().item()
        np.testing.assert_allclose(param.grad.numpy(), want[key].numpy(), rtol=1e-4,
                                   atol=1e-6 * max(scale, 1.0), err_msg=key)
    net.zero_grad(set_to_none=True)


def test_converter_agrees_with_the_jax_package_exporter(nets):
    _, params, net = nets
    want = vqvae_params_to_torch(params, CFG["num_residual_layer"])
    got = vqvae_state_dict_from_jax(params, CFG["num_residual_layer"])
    assert set(got) == set(want) == set(net.state_dict())
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)


def test_bf16_is_a_later_slice():
    """The name is older than bf16 training: bf16 serving runs
    (tests/test_torch_bf16_vqvae.py holds it against JAX), and so does the
    bf16 backward, ported by the bf16 training slice: fp32 output, fp32
    gradients on every fp32 parameter (tests/test_torch_bf16_train.py holds
    their values)."""
    net = VQVAENet(**CFG, compute_dtype="bfloat16", device="cpu")
    x = torch.randn((1, 4, 64), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert net(x).output.dtype == torch.float32
    out = net(x)
    assert out.output.dtype == torch.float32
    (out.output.abs().mean() + out.embedding_loss + out.commitment_loss).backward()
    for key, p in net.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, key


def test_seeded_init_is_reproducible_and_in_range():
    a, b = VQVAENet(**CFG, device="cpu", seed=7), VQVAENet(**CFG, device="cpu", seed=7)
    for (key, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), key
    cb = a.vector_quantizer.codebook.weight
    assert cb.abs().max() <= 1.0 / CFG["num_embedding"]
    w = a.encoder.conv2.weight  # fan_in = 8 * 4
    assert w.abs().max() <= 1.0 / (8 * 4) ** 0.5
