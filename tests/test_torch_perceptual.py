"""The port's VGG16 features and perceptual loss (msla_tpu_torch/nn/vgg.py,
nn/perceptual_loss.py) against the JAX package's on the CPU, on VGG weights
drawn with numpy from a seed as a flax tree (the JAX constructor's own flax
init is slow, so it is not called; the JAX side is jitted, its params an
argument):

* features on a (2, 3, 64, 51) image at atol = rtol = 1e-5;
* the loss at 4 kHz at rtol 1e-5, for waveforms (8000,), (2, 8000) and
  (2, 4, 8000), and through a flax msgpack file read by the port's decoder;
* dL/dx against ``jax.grad`` within 1e-5 of its largest magnitude, noise
  against tones, a silent stem included; dL/dtarget bit-equal to dL/dx with
  the arguments swapped (the loss is symmetric; the target's own gradient
  against a tone is ill-conditioned in fp32: JAX's and the port's both
  stray from fp64 by tens of percent there);
* ``chip_smoke.fp64_on_pieces`` (phase 31's reference): at 22 kHz the
  port's fp32 dL/dx within phase 31's tolerance of fp64 on the same ReLU
  masks and pool argmaxes, where fp64's own forward may take another piece;
* the layout: JAX's ``vgg16_params_from_torch`` on the port's state_dict;
* the init's bounds and seed, the frozen weights, loss(x, x) == 0, no graph
  for a target that needs no gradient, cuDNN's TF32 off in the backward
  whatever the caller's scope, and no CPU fallback for ``device=None``.
"""
import jax
import numpy as np
import pytest
import torch
from flax import serialization

import chip_smoke
from msla_tpu.nn.perceptual_loss import PerceptualLoss as JaxPerceptualLoss
from msla_tpu.nn.vgg import VGG16Features as JaxVGG16Features
from msla_tpu.utils.torch_compat import vgg16_params_from_torch
from msla_tpu_torch.nn import PerceptualLoss, VGG16Features
from msla_tpu_torch.nn.vgg import VGG16_CONV_INDICES, VGG16_PLAN
from msla_tpu_torch.utils import msgpack
from msla_tpu_torch.utils.jax_compat import vgg16_state_dict_from_jax

SR = 4000
SHAPES = [(8000,), (2, 8000), (2, 4, 8000)]


def _params(seed: int = 0) -> dict:
    """The JAX module's init as a flax tree: kernel (3, 3, in, out) and bias
    U(±1/√(9·in))."""
    rng = np.random.default_rng(seed)
    params, cin = {}, 3
    for i, cout in enumerate(s for s in VGG16_PLAN if s != "M"):
        limit = 1.0 / np.sqrt(9 * cin)
        params[f"conv{i}"] = {
            "kernel": rng.uniform(-limit, limit, (3, 3, cin, cout)).astype(np.float32),
            "bias": rng.uniform(-limit, limit, (cout,)).astype(np.float32)}
        cin = cout
    return params


def _waves(shape, seed: int) -> np.ndarray:
    return (0.3 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _tones(shape) -> np.ndarray:
    t = np.arange(shape[-1]) / SR
    f0 = 110.0 * 2.0 ** np.arange(np.prod(shape[:-1])).reshape(*shape[:-1], 1)
    return (0.3 * np.sin(2 * np.pi * f0 * t)).astype(np.float32)


def _jax_loss(params, x, t):
    return JaxPerceptualLoss(SR, params=params)(x, t)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the whole run's workers share the host's cores,
    and torch's threads, each worker's as many as the cores, contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX loss on the numpy weights, and its values and gradients on the
    inputs the tests share."""
    params = _params()
    loss, grad = jax.jit(_jax_loss), jax.jit(jax.grad(_jax_loss, argnums=(1,)))
    losses = {}
    for shape in SHAPES:
        x, t = _waves(shape, 1), _waves(shape, 2)
        losses[shape] = (x, t, float(loss(params, x, t)))
    x = _waves((2, 8000), 3)
    x[1] = 0.0                                   # a silent stem
    t = _tones((2, 8000))
    gx = np.asarray(grad(params, x, t)[0])
    return dict(params=params, features=jax.jit(JaxVGG16Features().apply), losses=losses,
                grad=(x, t, gx))


@pytest.fixture(scope="module")
def port(jax_side):
    return PerceptualLoss(SR, state_dict=vgg16_state_dict_from_jax(jax_side["params"]),
                          device="cpu")


def test_features_match_jax(jax_side, port):
    x = np.random.default_rng(5).standard_normal((2, 3, 64, 51)).astype(np.float32)
    want = np.asarray(jax_side["features"]({"params": jax_side["params"]},
                                           x.transpose(0, 2, 3, 1)))
    got = port.net(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 512, 2, 1)           # 64 → 2, 51 → 25 → 12 → 6 → 3 → 1
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_loss_matches_jax(jax_side, port, shape):
    x, t, want = jax_side["losses"][shape]
    got = port(torch.from_numpy(x), torch.from_numpy(t))
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)


def _port_grads(pl, x, t, dtype=torch.float32):
    xt, tt = (torch.from_numpy(a).to(dtype).requires_grad_(True) for a in (x, t))
    pl(xt, tt).backward()
    return xt.grad.numpy(), tt.grad.numpy()


def test_gradients_match_jax_with_a_silent_stem(jax_side, port):
    x, t, want = jax_side["grad"]
    gx, gt = _port_grads(port, x, t)
    assert np.isfinite(gx).all() and np.isfinite(want).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(gx, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert not gx[1].any()                       # the silent stem's
    swapped_gt, swapped_gx = _port_grads(port, t, x)
    assert np.array_equal(gt, swapped_gt) and np.array_equal(gx, swapped_gx)
    assert np.isfinite(gt).all() and np.abs(gt).max() > 0


def test_fp32_within_phase31_tolerance_of_fp64_on_its_pieces():
    rng = np.random.default_rng(12)
    x, t = (torch.from_numpy((0.2 * rng.standard_normal((1, 4, 8800))).astype(np.float32))
            for _ in range(2))
    pl = PerceptualLoss(chip_smoke.SR, device="cpu")
    fp64 = PerceptualLoss(chip_smoke.SR, state_dict=pl.net.state_dict(), device="cpu")
    fp64.net.double()
    loss, grad = chip_smoke.perceptual_grads(pl, x, t, scoped=False)
    loss64, grad64 = chip_smoke.perceptual_grads(fp64, x.double(), t.double(), scoped=False)
    piece_loss, piece_grad, _ = chip_smoke.fp64_on_pieces(pl, x, t)
    on_pieces = chip_smoke.against("fp32", loss, grad, piece_loss, piece_grad)
    assert chip_smoke.against("fp32", loss, grad, loss64, grad64)["loss_rel"] <= (
        chip_smoke.PERCEPTUAL_LOSS_RTOL)
    assert on_pieces["grad_rel"] <= chip_smoke.PERCEPTUAL_GRAD_TOL


def test_jax_reads_the_port_state_dict(jax_side):
    net = VGG16Features(generator=torch.Generator().manual_seed(7), device="cpu")
    sd = net.state_dict()
    assert sorted(sd) == sorted(f"features.{j}.{k}" for j in VGG16_CONV_INDICES
                                for k in ("weight", "bias"))
    x = np.random.default_rng(6).standard_normal((2, 3, 64, 51)).astype(np.float32)
    want = np.asarray(jax_side["features"]({"params": vgg16_params_from_torch(sd)},
                                           x.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(net(torch.from_numpy(x)).numpy(), want.transpose(0, 3, 1, 2),
                               atol=1e-5, rtol=1e-5)
    back = vgg16_state_dict_from_jax(vgg16_params_from_torch(sd))
    assert all(torch.equal(back[k], v) for k, v in sd.items())


def test_a_flax_msgpack_file_gives_the_same_loss(jax_side, tmp_path):
    path = tmp_path / "vgg16_features.msgpack"
    path.write_bytes(serialization.msgpack_serialize(jax_side["params"]))
    pl = PerceptualLoss(SR, state_dict=vgg16_state_dict_from_jax(msgpack.read(path)),
                        device="cpu")
    x, t, want = jax_side["losses"][(2, 8000)]
    np.testing.assert_allclose(pl(torch.from_numpy(x), torch.from_numpy(t)).item(), want,
                               rtol=1e-5)


def test_init_bounds_and_seed():
    a = VGG16Features(generator=torch.Generator().manual_seed(3), device="cpu")
    b = VGG16Features(generator=torch.Generator().manual_seed(3), device="cpu")
    c = VGG16Features(device="cpu")
    d = VGG16Features(generator=torch.Generator().manual_seed(0), device="cpu")
    for name, p in a.named_parameters():
        cin = p.shape[1] if p.ndim == 4 else a.state_dict()[name[:-4] + "weight"].shape[1]
        limit = 1.0 / np.sqrt(9 * cin)
        assert p.abs().max() <= limit and p.abs().max() > 0.9 * limit, name
        assert torch.equal(p, b.state_dict()[name])
    assert all(torch.equal(v, d.state_dict()[k]) for k, v in c.state_dict().items())
    assert not torch.equal(a.features[0].weight, c.features[0].weight)


def test_frozen_weights_zero_self_loss_and_no_target_graph(port):
    x = torch.from_numpy(_waves((2, 8000), 8)).requires_grad_(True)
    assert port(x, x.detach()).item() == 0.0
    assert port._features(x.detach()).grad_fn is None
    loss = port(x, torch.from_numpy(_waves((2, 8000), 9)))
    loss.backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert all(not p.requires_grad and p.grad is None for p in port.net.parameters())
    net = VGG16Features(device="cpu").requires_grad_(True)
    with pytest.raises(ValueError, match="frozen"):
        net(torch.zeros(1, 3, 32, 32, requires_grad=True))


def test_backward_runs_with_cudnn_tf32_off(port, monkeypatch):
    """The adjoints run in fp32 though backward() is called with cuDNN's TF32
    on and outside any scope: the flag read inside the VGG backward."""
    seen = []
    unpool = torch.nn.functional.max_unpool2d

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return unpool(*args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "max_unpool2d", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    x = torch.from_numpy(_waves((8000,), 10)).requires_grad_(True)
    loss = port(x, torch.from_numpy(_waves((8000,), 11)))
    assert torch.backends.cudnn.allow_tf32
    loss.backward()
    assert seen == [False] * 5 and torch.backends.cudnn.allow_tf32


def test_default_device_is_the_card_and_refuses_to_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PerceptualLoss(SR)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VGG16Features()
