"""bf16 training on the CPU against the JAX package (compute_dtype="bfloat16").

* The stems' save-hidden forwards: ``conv_stem_save_hidden`` and
  ``deconv_stem_save_hidden`` on bf16 operands (the plain versions here, the
  function K1b and K2b compute in bf16 on the card) against
  conv_stem_pallas / deconv_stem_pallas(save_hidden=True) in interpret mode:
  out and the hidden within 1 bf16 ulp of the larger value.
* The stems' bf16 backward: gradients through ``conv_stem`` / ``deconv_stem``
  (the port's autograd.Functions) against the JAX package's own ``_fused_bwd``
  (msla_tpu/ops/conv_stem.py:177, deconv_stem.py:180) on the residuals that
  the Pallas forward made in interpret mode (the test first checks that the
  port's residuals are those bits). The biases' gradients within 1e-5 of
  their value plus Σ|terms| (fp32 sums of the same bf16 values in another
  order, which may cancel: measured 1.9e-5 of a value of 0.025, 6.9e-9 of
  its Σ|terms|); dx, dq and the weights' gradients within 1 bf16 ulp of the larger
  magnitude plus 1e-5 of Σ|terms| (where the two fp32 sums agree to 1e-5 of
  Σ|terms|, their bf16 roundings are at most an ulp apart). Measured:
  bit-equal on these inputs.
* A small VQVAETask in bf16: the first step's loss and gradients, and 3
  ``Trainer.fit`` steps, against the JAX VQVAETask and Trainer with
  compute_dtype="bfloat16". These are not the same function: the JAX default
  stems are XLA's, which add a bias rounded to bf16 before the ReLU, where the
  port runs the Pallas function (the fp32 bias); and the two frameworks' CPU
  convs sum in other orders before each bf16 rounding, which the backward
  carries through every layer. So each parameter's gradient is held to
  twice the distance that JAX's own bf16 rounding puts between JAX's bf16 and
  fp32 gradients (measured: at most 1.37 of it, on encoder.conv1.bias; 0.11
  of scale on encoder.conv1, where tests/test_torch_bf16_vqvae.py holds
  whole bf16 forwards within 0.02 of scale), the loss to rtol 1e-3 (measured 4.5e-4), the metrics after 3
  steps to rtol 5e-3 (measured 1.5e-3), and each parameter's move over 3
  steps to JAX's at 0.2·lr where JAX's first-step gradient is above 0.1 of
  its tensor's largest (measured 0.073·lr): there rounding cannot flip the
  sign of Adam's step.
* ``precision="high"`` and any other string train exactly as "medium".
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_layout import ncw, t32, torch_weight
from msla_tpu.models.vqvae import VQVAETask as JaxVQVAETask
from msla_tpu.train.trainer import Trainer as JaxTrainer
from msla_tpu_torch.models.vqvae import VQVAETask
from msla_tpu_torch.ops.conv_stem import conv_stem, conv_stem_save_hidden
from msla_tpu_torch.ops.deconv_stem import deconv_stem, deconv_stem_save_hidden
from msla_tpu_torch.train.trainer import Trainer
from msla_tpu_torch.utils.jax_compat import vqvae_state_dict_from_jax
from test_torch_train import CFG, B, JaxDM, PortDM

jax_conv_stem = importlib.import_module("msla_tpu.ops.conv_stem")
jax_deconv_stem = importlib.import_module("msla_tpu.ops.deconv_stem")

BF = torch.bfloat16
T = 512
NL = CFG["num_residual_layer"]


def _f32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


def _ulp(m: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at magnitude m (fp32)."""
    return torch.ldexp(torch.ones_like(m), torch.frexp(m)[1] - 8)


def _within_an_ulp(name, got: torch.Tensor, want: torch.Tensor, terms=None) -> None:
    got, want = got.float(), want.float()
    slack = 0.0 if terms is None else 1e-5 * terms
    bad = (got - want).abs() > _ulp(torch.maximum(got.abs(), want.abs())) + slack
    assert not bad.any(), f"{name}: {bad.sum().item()} values beyond 1 bf16 ulp"


def _conv_args(t, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, t, 4)).astype(np.float32),
            (rng.standard_normal((4, 4, 8)) * 0.2).astype(np.float32),
            (rng.standard_normal((8,)) * 0.1).astype(np.float32),
            (rng.standard_normal((4, 8, 16)) * 0.2).astype(np.float32),
            (rng.standard_normal((16,)) * 0.1).astype(np.float32))


def _deconv_args(w, seed):
    rng = np.random.default_rng(seed)
    return (np.abs(rng.standard_normal((2, w, 16))).astype(np.float32),
            (rng.standard_normal((4, 8, 16)) * 0.2).astype(np.float32),
            (rng.standard_normal((8,)) * 0.1).astype(np.float32),
            (rng.standard_normal((4, 4, 8)) * 0.2).astype(np.float32),
            (rng.standard_normal((4,)) * 0.1).astype(np.float32))


def _jax_bf16(x, w1, b1, w2, b2):
    bf = jnp.bfloat16
    return (jnp.asarray(x, bf), jnp.asarray(w1, bf), jnp.asarray(b1), jnp.asarray(w2, bf),
            jnp.asarray(b2))


def _port_bf16(x, w1, b1, w2, b2, grad=False):
    args = [ncw(x).to(BF), torch_weight(w1).to(BF), t32(b1), torch_weight(w2).to(BF), t32(b2)]
    return [a.requires_grad_(grad) for a in args]


@pytest.mark.parametrize("t,tile", [(64, 8), (256, 16), (192, 48)])
def test_conv_save_hidden_bf16_matches_jax_pallas_interpret(t, tile):
    args = _conv_args(t, seed=t)
    want_out, want_h = jax_conv_stem.conv_stem_pallas(*_jax_bf16(*args), save_hidden=True,
                                                     tile_w=tile, interpret=True)
    out, h = conv_stem_save_hidden(*_port_bf16(*args))
    assert out.dtype == h.dtype == BF and h.shape == (2, 8, t // 2)
    _within_an_ulp("out", out, ncw(_f32(want_out)))
    _within_an_ulp("h1", h, ncw(_f32(want_h)))


@pytest.mark.parametrize("w,tile", [(16, 8), (64, 16), (48, 24)])
def test_deconv_save_hidden_bf16_matches_jax_pallas_interpret(w, tile):
    args = _deconv_args(w, seed=w)
    want_out, want_h = jax_deconv_stem.deconv_stem_pallas(*_jax_bf16(*args), save_hidden=True,
                                                         tile_w=tile, interpret=True)
    out, h = deconv_stem_save_hidden(*_port_bf16(*args))
    assert out.dtype == h.dtype == BF and h.shape == (2, 8, 2 * w)
    _within_an_ulp("out", out, ncw(_f32(want_out)))
    _within_an_ulp("h", h, ncw(_f32(want_h)))


def _abs_adjoints(g, x, w, transposed):
    """Σ|terms| of each input and weight gradient of a k4 s2 p1 conv, fp64."""
    return torch.ops.aten.convolution_backward(
        g.double().abs(), x.double().abs(), w.double().abs(), None, [2], [1], [1], transposed,
        [0], 1, [True, True, False])[:2]


def _check_backward(got, want, terms):
    names = ("input", "w1", "b1", "w2", "b2")
    for name, a, b, s in zip(names, got, want, terms):
        assert a.dtype == (torch.float32 if name.startswith("b") else BF), name
        if name.startswith("b"):
            assert ((a - b).abs() <= 1e-5 * (b.abs() + s)).all(), name
        else:
            _within_an_ulp(name, a, b, s)


@pytest.mark.parametrize("t,tile", [(64, 8), (256, 16), (192, 48)])
def test_conv_stem_bf16_backward_matches_jax_fused_bwd(t, tile):
    args = _conv_args(t, seed=t + 1)
    jx, jw1, jb1, jw2, jb2 = _jax_bf16(*args)
    out, h1 = jax_conv_stem.conv_stem_pallas(jx, jw1, jb1, jw2, jb2, save_hidden=True,
                                             tile_w=tile, interpret=True)
    g = jnp.asarray(np.random.default_rng(t).standard_normal(out.shape), jnp.bfloat16)
    dx, dw1, db1, dw2, db2 = jax_conv_stem._fused_bwd((jx, h1, out, jw1, jw2), g)

    targs = _port_bf16(*args, grad=True)
    port_out, port_h1 = conv_stem_save_hidden(*(a.detach() for a in targs))
    assert torch.equal(port_out.float(), ncw(_f32(out)))  # the same residuals
    assert torch.equal(port_h1.float(), ncw(_f32(h1)))
    gt = ncw(_f32(g)).to(BF)
    conv_stem(*targs).backward(gt)
    g2 = torch.where(port_out > 0, gt, 0)
    _, dw2_terms = _abs_adjoints(g2, port_h1, targs[3].detach(), False)
    dh1 = torch.ops.aten.convolution_backward(
        g2.double(), port_h1.double(), targs[3].detach().double(), None, [2], [1], [1], False,
        [0], 1, [True, False, False])[0]
    dx_terms, dw1_terms = _abs_adjoints(torch.where(port_h1 > 0, dh1, 0), targs[0].detach(),
                                        targs[1].detach(), False)
    _check_backward([a.grad for a in targs],
                    [ncw(_f32(dx)), torch_weight(_f32(dw1)), t32(db1), torch_weight(_f32(dw2)),
                     t32(db2)],
                    [dx_terms, dw1_terms, torch.where(port_h1 > 0, dh1, 0).abs().sum((0, 2)),
                     dw2_terms, g2.float().abs().sum((0, 2))])


@pytest.mark.parametrize("w,tile", [(16, 8), (64, 16), (48, 24)])
def test_deconv_stem_bf16_backward_matches_jax_fused_bwd(w, tile):
    args = _deconv_args(w, seed=w + 1)
    jq, jw1, jb1, jw2, jb2 = _jax_bf16(*args)
    out, h = jax_deconv_stem.deconv_stem_pallas(jq, jw1, jb1, jw2, jb2, save_hidden=True,
                                               tile_w=tile, interpret=True)
    g = jnp.asarray(np.random.default_rng(w).standard_normal(out.shape), jnp.bfloat16)
    dq, dw1, db1, dw2, db2 = jax_deconv_stem._fused_bwd((jq, h, jw1, jw2), g)

    targs = _port_bf16(*args, grad=True)
    port_out, port_h = deconv_stem_save_hidden(*(a.detach() for a in targs))
    assert torch.equal(port_out.float(), ncw(_f32(out)))
    assert torch.equal(port_h.float(), ncw(_f32(h)))
    gt = ncw(_f32(g)).to(BF)
    deconv_stem(*targs).backward(gt)
    _, dw2_terms = _abs_adjoints(gt, port_h, targs[3].detach(), True)
    dh = torch.ops.aten.convolution_backward(
        gt.double(), port_h.double(), targs[3].detach().double(), None, [2], [1], [1], True,
        [0], 1, [True, False, False])[0]
    dq_terms, dw1_terms = _abs_adjoints(torch.where(port_h > 0, dh, 0), targs[0].detach(),
                                        targs[1].detach(), True)
    _check_backward([a.grad for a in targs],
                    [ncw(_f32(dq)), torch_weight(_f32(dw1)), t32(db1), torch_weight(_f32(dw2)),
                     t32(db2)],
                    [dq_terms, dw1_terms, torch.where(port_h > 0, dh, 0).abs().sum((0, 2)),
                     dw2_terms, gt.float().abs().sum((0, 2))])


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, 4, T)) * 0.3).astype(np.float32) for _ in range(n)]


TRAIN, VAL = _batches(3, 20), _batches(2, 21)


def _paths(tmp):
    return dict(checkpoint_dir=str(tmp), codebook_file=str(tmp / "codebook.csv"))


@pytest.fixture(scope="module")
def jax_bf16(tmp_path_factory):
    """The JAX bf16 task, its seed-0 params and its first-step gradients in
    bf16 and in fp32 (the same params and batch)."""
    tmp = tmp_path_factory.mktemp("jax_bf16")
    task = JaxVQVAETask(**CFG, **_paths(tmp), compute_dtype="bfloat16")
    fp32 = JaxVQVAETask(**CFG, **_paths(tmp))
    batch = JaxDM(TRAIN, VAL).on_after_batch_transfer(jnp.asarray(TRAIN[0]))
    params = task.init_variables(jax.random.PRNGKey(0), batch)["params"]
    loss, grads = jax.value_and_grad(
        lambda p: task.loss_fn(p, batch, jax.random.PRNGKey(0))[0])(params)
    grads32 = jax.grad(lambda p: fp32.loss_fn(p, batch, jax.random.PRNGKey(0))[0])(params)
    return (task, params, float(loss), vqvae_state_dict_from_jax(grads, NL),
            vqvae_state_dict_from_jax(grads32, NL))


def _port_task(params, tmp):
    task = VQVAETask(**CFG, **_paths(tmp), compute_dtype="bfloat16", device="cpu")
    task.net.load_state_dict(vqvae_state_dict_from_jax(params, NL))
    return task


def test_first_bf16_step_gradients_match_jax(jax_bf16, tmp_path):
    _, params, want_loss, want, want32 = jax_bf16
    task = _port_task(params, tmp_path)
    loss, _ = task.loss_fn(PortDM(TRAIN, VAL).on_after_batch_transfer(
        torch.from_numpy(TRAIN[0])), None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-3)
    for key, param in task.net.named_parameters():
        assert param.dtype == param.grad.dtype == torch.float32, key
        jax_rounding = (want[key] - want32[key]).abs().max().item()
        err = (param.grad - want[key]).abs().max().item()
        assert err <= 2 * jax_rounding, (key, err, jax_rounding)


def test_the_vq_stays_fp32_and_its_gradient_reaches_the_bf16_encoder(jax_bf16, tmp_path):
    """#4/#5's function runs on fp32 latents under the bf16 network, and the
    straight-through gradient reaches the encoder's bf16 output in bf16."""
    _, params, _, _, _ = jax_bf16
    task = _port_task(params, tmp_path)
    seen = {}

    def encoder_out(_, __, out):
        out.register_hook(lambda g: seen.__setitem__("enc", g.dtype))

    task.net.encoder.register_forward_hook(encoder_out)
    task.net.vector_quantizer.register_forward_hook(
        lambda _, inputs, __: seen.__setitem__("vq", inputs[0].dtype))
    task.loss_fn(PortDM(TRAIN, VAL).on_after_batch_transfer(torch.from_numpy(TRAIN[0])),
                 None)[0].backward()
    assert seen == {"vq": torch.float32, "enc": BF}


def test_three_bf16_fit_steps_match_jax_trainer(jax_bf16, tmp_path):
    jax_task, params, _, grads, _ = jax_bf16
    jax_trainer = JaxTrainer(default_root_dir=str(tmp_path), max_epochs=1, accelerator="cpu",
                             enable_progress_bar=False, log_every_n_steps=0, seed=0)
    jax_trainer.fit(jax_task, JaxDM(TRAIN, VAL))
    task = _port_task(params, tmp_path / "port")
    trainer = Trainer(max_epochs=1, accelerator="cpu", enable_progress_bar=False,
                      log_every_n_steps=0, seed=0)
    trainer.fit(task, PortDM(TRAIN, VAL))
    assert trainer.global_step == jax_trainer.global_step == 3

    want = jax_trainer.callback_metrics
    assert set(trainer.callback_metrics) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(trainer.callback_metrics[k], v, rtol=5e-3, err_msg=k)

    start = vqvae_state_dict_from_jax(params, NL)
    want_sd = vqvae_state_dict_from_jax(jax.device_get(jax_trainer.state.params), NL)
    lr = CFG["learning_rate"]
    for key, value in task.net.state_dict().items():
        assert value.dtype == torch.float32, key
        g = grads[key].abs()
        sure = g > 0.1 * g.max()
        moved, want_moved = value - start[key], want_sd[key] - start[key]
        assert want_moved[sure].abs().max() > lr, key
        np.testing.assert_allclose(moved[sure].numpy(), want_moved[sure].numpy(), rtol=0,
                                   atol=0.2 * lr, err_msg=key)


@pytest.mark.parametrize("precision", ["high", "bf16-mixed"])
def test_other_precisions_train_as_medium(jax_bf16, tmp_path, precision):
    """The JAX Trainer's precision only picks XLA's matmul passes; the port
    runs fp32 with TF32 off at every value, so the weights come out equal."""
    _, params, _, _, _ = jax_bf16
    states = []
    for p in ("medium", precision):
        task = _port_task(params, tmp_path / p)
        Trainer(max_epochs=1, limit_train_batches=2, accelerator="cpu",
                enable_progress_bar=False, precision=p).fit(task, PortDM(TRAIN, VAL))
        states.append(task.net.state_dict())
    for key, value in states[0].items():
        assert torch.equal(value, states[1][key]), key
