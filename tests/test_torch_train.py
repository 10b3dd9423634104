"""The VQ-VAE training slice on the CPU against the JAX package, on the same
weights (msla_tpu's init passed through vqvae_state_dict_from_jax).

* loss_fn and every eval metric against msla_tpu.models.vqvae.VQVAETask at
  rtol 1e-4, atol 1e-5 (conv stacks summed in another order);
* first-step parameter gradients against jax.grad at rtol 1e-4 and atol 1e-6
  of each gradient's largest entry;
* 3 steps of the port's Trainer.fit against JAX's Trainer(accelerator="cpu")
  .fit on the same batches, masking off. callback_metrics at rtol 1e-3: Adam
  divides each update by √v, so a parameter whose gradient is near 0 moves by
  up to lr whatever the last digits of that gradient, and rounding that is
  1e-6 in the gradients reaches 1e-4..1e-3 in the metrics after 3 steps.
  The parameters' moves (after minus before, up to steps·lr) are held to
  JAX's at atol 0.2·lr, on the entries whose first-step gradient is above
  1e-3 of its tensor's largest: there Adam's step has a sign that rounding
  cannot flip. A skipped or wrongly signed update fails this.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from msla_tpu.data.datamodule import SlakhDataModule as JaxSlakhDataModule
from msla_tpu.models.vqvae import VQVAETask as JaxVQVAETask
from msla_tpu.train.trainer import Trainer as JaxTrainer
from msla_tpu_torch.data.datamodule import SlakhDataModule
from msla_tpu_torch.models.vqvae import VQVAETask
from msla_tpu_torch.train.trainer import Trainer
from msla_tpu_torch.utils.jax_compat import vqvae_state_dict_from_jax

CFG = dict(num_hidden=16, num_residual_layer=2, num_residual_hidden=8, num_embedding=16,
           embedding_dim=8, commitment_cost=0.25, learning_rate=1e-4, sample_rate=1000)
B, T = 2, 800
TOL = dict(rtol=1e-4, atol=1e-5)
DM_ARGS = dict(train_dir="t", val_dir="v", test_dir="s", target_sample_rate=1000,
               target_sample_duration=2, max_duration=120, maximum_dataset_size=100,
               batch_size=B)


def _batches(n, seed, t=T):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, 4, t)) * 0.3).astype(np.float32) for _ in range(n)]


TRAIN, VAL = _batches(3, 0), _batches(2, 1)


class JaxDM(JaxSlakhDataModule):
    def __init__(self, train, val, **kw):
        super().__init__(**DM_ARGS, **kw)
        self.train, self.val = train, val

    def train_dataloader(self):
        return list(self.train)

    def val_dataloader(self):
        return list(self.val)


class PortDM(SlakhDataModule):
    def __init__(self, train, val, **kw):
        super().__init__(**DM_ARGS, **kw)
        self.train, self.val = train, val

    def train_dataloader(self):
        return list(self.train)

    def val_dataloader(self):
        return list(self.val)


def _paths(tmp):
    return dict(checkpoint_dir=str(tmp), codebook_file=str(tmp / "codebook.csv"))


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX task and the params its Trainer builds (seed 0, first batch)."""
    task = JaxVQVAETask(**CFG, **_paths(tmp_path_factory.mktemp("jax")))
    batch0 = JaxDM(TRAIN, VAL).on_after_batch_transfer(jnp.asarray(TRAIN[0]))
    return task, task.init_variables(jax.random.PRNGKey(0), batch0)["params"]


def _port_task(params, tmp):
    task = VQVAETask(**CFG, **_paths(tmp), device="cpu")
    task.net.load_state_dict(vqvae_state_dict_from_jax(params, CFG["num_residual_layer"]))
    return task


def _batch(raw):
    return PortDM(TRAIN, VAL).on_after_batch_transfer(torch.from_numpy(raw))


def test_loss_fn_matches_jax(jax_side, tmp_path):
    jax_task, params = jax_side
    batch = JaxDM(TRAIN, VAL).on_after_batch_transfer(jnp.asarray(TRAIN[1]))
    want_loss, want = jax_task.loss_fn(params, batch, jax.random.PRNGKey(0))
    loss, got = _port_task(params, tmp_path).loss_fn(_batch(TRAIN[1]), None)
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    assert set(got) == set(want) == {"train/loss", "train/perplexity"}
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("mode", ["validation", "test"])
def test_eval_metrics_match_jax(jax_side, tmp_path, mode):
    jax_task, params = jax_side
    batch = JaxDM(TRAIN, VAL).on_after_batch_transfer(jnp.asarray(VAL[0]))
    want = jax_task.eval_metrics(params, batch, mode)
    with torch.no_grad():
        got = _port_task(params, tmp_path).eval_metrics(_batch(VAL[0]), mode)
    assert set(got) == set(want) and len(got) == 19
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=k, **TOL)


def test_first_step_gradients_match_jax(jax_side, tmp_path):
    jax_task, params = jax_side
    batch = JaxDM(TRAIN, VAL).on_after_batch_transfer(jnp.asarray(TRAIN[0]))
    grads = jax.grad(lambda p: jax_task.loss_fn(p, batch, jax.random.PRNGKey(0))[0])(params)
    want = vqvae_state_dict_from_jax(grads, CFG["num_residual_layer"])
    task = _port_task(params, tmp_path)
    task.loss_fn(_batch(TRAIN[0]), None)[0].backward()
    for key, param in task.net.named_parameters():
        scale = max(want[key].abs().max().item(), 1e-30)
        np.testing.assert_allclose(param.grad.numpy(), want[key].numpy(), rtol=1e-4,
                                   atol=1e-6 * scale, err_msg=key)


def test_three_fit_steps_match_jax_trainer(jax_side, tmp_path):
    jax_task, params = jax_side
    jax_trainer = JaxTrainer(default_root_dir=str(tmp_path), max_epochs=1, accelerator="cpu",
                             enable_progress_bar=False, log_every_n_steps=0, seed=0)
    jax_trainer.fit(jax_task, JaxDM(TRAIN, VAL))

    task = _port_task(params, tmp_path / "port")
    trainer = Trainer(max_epochs=1, accelerator="cpu", enable_progress_bar=False,
                      log_every_n_steps=0, seed=0)
    trainer.fit(task, PortDM(TRAIN, VAL))
    assert trainer.global_step == jax_trainer.global_step == 3
    assert trainer.current_epoch == jax_trainer.current_epoch == 1

    want = jax_trainer.callback_metrics
    assert set(trainer.callback_metrics) == set(want) and len(want) == 21
    for k, v in want.items():
        np.testing.assert_allclose(trainer.callback_metrics[k], v, rtol=1e-3, err_msg=k)

    start = vqvae_state_dict_from_jax(params, CFG["num_residual_layer"])
    want_sd = vqvae_state_dict_from_jax(jax.device_get(jax_trainer.state.params),
                                        CFG["num_residual_layer"])
    batch = JaxDM(TRAIN, VAL).on_after_batch_transfer(jnp.asarray(TRAIN[0]))
    grads = vqvae_state_dict_from_jax(
        jax.grad(lambda p: jax_task.loss_fn(p, batch, jax.random.PRNGKey(0))[0])(params),
        CFG["num_residual_layer"])
    lr = CFG["learning_rate"]
    for key, value in task.net.state_dict().items():
        g = grads[key].abs()
        sure = g > 1e-3 * g.max()
        moved, want_moved = value - start[key], want_sd[key] - start[key]
        assert want_moved[sure].abs().max() > lr, key
        np.testing.assert_allclose(moved[sure].numpy(), want_moved[sure].numpy(), rtol=0,
                                   atol=0.2 * lr, err_msg=key)


def test_fit_writes_the_codebook_csv_and_moves_every_parameter(jax_side, tmp_path):
    """With masking on. Frames of 4,000 samples have 21 STFT frames, so the
    time mask (a span of up to 19) leaves some signal; at 800 it may blank
    all 5, as the reference's would."""
    _, params = jax_side
    task = _port_task(params, tmp_path)
    before = {k: v.clone() for k, v in task.net.state_dict().items()}
    Trainer(max_epochs=1, accelerator="cpu", enable_progress_bar=False).fit(
        task, PortDM(_batches(2, 3, t=4000), _batches(1, 4, t=4000), masking=True))
    for key, value in task.net.state_dict().items():
        assert not torch.equal(value, before[key]), key
    csv = np.loadtxt(tmp_path / "codebook.csv", delimiter=",", skiprows=1)
    np.testing.assert_array_equal(csv.astype(np.float32),
                                  task.net.vector_quantizer.codebook.weight.detach().numpy())


def test_backward_runs_with_cudnn_tf32_off(jax_side, tmp_path):
    """The convs' adjoints run when loss.backward() runs, outside the forward's
    fp32 scope: the Trainer gives the backward one of its own. Hooks on a
    residual conv's and the decoder's first conv's weight gradients read
    cuDNN's TF32 flag while the backward computes them."""
    _, params = jax_side
    task = _port_task(params, tmp_path)
    seen = []
    for w in (task.net.encoder.residual_stack.residual_layers[0][1].weight,
              task.net.decoder.conv1.weight):
        w.register_hook(lambda g: seen.append(torch.backends.cudnn.allow_tf32))
    assert torch.backends.cudnn.allow_tf32  # torch's default, outside any scope
    Trainer(max_epochs=1, limit_train_batches=2, accelerator="cpu",
            enable_progress_bar=False).fit(task, PortDM(TRAIN, VAL))
    assert len(seen) == 4 and not any(seen)
    assert torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("kw,steps,epochs", [(dict(fast_dev_run=True, max_epochs=5), 1, 1),
                                             (dict(max_epochs=2, limit_train_batches=2), 4, 2),
                                             (dict(max_epochs=1, limit_train_batches=0.5), 1, 1)])
def test_fit_steps_and_epochs(jax_side, tmp_path, kw, steps, epochs):
    _, params = jax_side
    trainer = Trainer(accelerator="cpu", enable_progress_bar=False, **kw)
    trainer.fit(_port_task(params, tmp_path), PortDM(TRAIN, VAL))
    assert (trainer.global_step, trainer.current_epoch) == (steps, epochs)
    assert np.isfinite(trainer.callback_metrics["validation/loss"])


def test_epoch_means_are_weighted_by_batch_size(jax_side, tmp_path):
    """A ragged last batch counts by its rows, as Lightning's on_epoch mean."""
    _, params = jax_side
    task = _port_task(params, tmp_path)
    val = [VAL[0], VAL[1][:1]]
    metrics = Trainer(accelerator="cpu", enable_progress_bar=False).validate(
        task, PortDM(TRAIN, val))
    with torch.no_grad():
        per_batch = [task.eval_metrics(_batch(v), "validation")["validation/loss"].item()
                     for v in val]
    np.testing.assert_allclose(metrics["validation/loss"], (2 * per_batch[0] + per_batch[1]) / 3,
                               rtol=1e-6)


def test_adam_is_optax_adam(jax_side, tmp_path):
    """configure_optimizer's update equals optax.adam's for two steps."""
    _, params = jax_side
    task = _port_task(params, tmp_path)
    opt = task.configure_optimizer()
    p = task.net.vector_quantizer.codebook.weight
    start = p.detach().numpy().copy()
    tx = optax.adam(CFG["learning_rate"], b1=0.9, b2=0.999, eps=1e-8)
    jp = jnp.asarray(start)
    state = tx.init(jp)
    rng = np.random.default_rng(2)
    for _ in range(2):
        g = rng.standard_normal(start.shape).astype(np.float32)
        opt.zero_grad()
        p.grad = torch.from_numpy(g)
        opt.step()
        updates, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("kw,match", [
    (dict(model_parallel=2), "1 devices not divisible by the model-axis size 2"),
    (dict(pipeline_parallel=2), "1 devices not divisible by the model-axis size 2"),
    (dict(model_parallel=3, zero1=True), "1 devices not divisible by the model-axis size 3"),
    (dict(model_parallel=2, pipeline_parallel=2), "both use the `model` mesh axis"),
    (dict(fsdp=True, pipeline_parallel=2), "fsdp shards parameters over `data`"),
    (dict(pipeline_microbatches=0), "pipeline_microbatches=0 must be >= 1")])
def test_trainer_keywords_jax_refuses_raise_its_value_error(kw, match):
    """The JAX Trainer's ValueErrors, worded as JAX words them
    (msla_tpu/train/trainer.py:145-156, msla_tpu/parallel/mesh.py:65-67): a
    world that model_parallel or pipeline_parallel does not divide (one
    process is a world of one) and the pairings it forbids, before any step."""
    with pytest.raises(ValueError, match=match):
        Trainer(accelerator="cpu", **kw)


@pytest.mark.parametrize("kw", [dict(zero1=True), dict(fsdp=True), dict(zero1=True, fsdp=True)])
def test_sharded_state_keywords_change_nothing_in_one_process(kw, tmp_path):
    """Without a process group zero1 and fsdp keep the one-process path: a
    fit ends bit-equal to the fit without them."""
    states = []
    for extra in ({}, kw):
        task = VQVAETask(**CFG, checkpoint_dir=str(tmp_path), codebook_file=str(tmp_path / "c"),
                         device="cpu", seed=0)
        Trainer(max_epochs=1, accelerator="cpu", enable_progress_bar=False, log_every_n_steps=0,
                seed=0, **extra).fit(task, PortDM(TRAIN, VAL))
        states.append(task.net.state_dict())
    for key, value in states[0].items():
        assert torch.equal(states[1][key], value), key


def test_pipeline_microbatches_change_nothing_at_pp_1(tmp_path):
    """At pipeline_parallel 1 the steps run loss_fn, as the JAX Trainer's do
    (msla_tpu/train/trainer.py:340-361): pipeline_microbatches is read by
    the pipeline alone, and a fit ends bit-equal to the default's."""
    states = []
    for extra in ({}, dict(pipeline_microbatches=4)):
        task = VQVAETask(**CFG, checkpoint_dir=str(tmp_path), codebook_file=str(tmp_path / "c"),
                         device="cpu", seed=0)
        Trainer(max_epochs=1, accelerator="cpu", enable_progress_bar=False, log_every_n_steps=0,
                seed=0, **extra).fit(task, PortDM(TRAIN, VAL))
        states.append(task.net.state_dict())
    for key, value in states[0].items():
        assert torch.equal(states[1][key], value), key


@pytest.mark.parametrize("kw", [dict(devices=2), dict(num_nodes=2)])
def test_trainer_devices_without_a_matching_group_raise(kw):
    """Data parallelism needs one process a device, which the launcher
    starts: a lone process asked for two devices or two nodes names it."""
    with pytest.raises(ValueError, match="msla_tpu_torch.parallel.launch"):
        Trainer(accelerator="cpu", **kw)


def test_ckpt_path_waits_and_the_task_must_share_the_trainers_device(jax_side, tmp_path):
    """The name is older than checkpoints, which the bf16 training slice
    ported (tests/test_torch_checkpoint.py): what stays is the device check."""
    _, params = jax_side
    task = _port_task(params, tmp_path)
    trainer = Trainer(accelerator="cpu", enable_progress_bar=False)
    task.net.to("meta")
    with pytest.raises(ValueError, match="device='cpu'"):
        trainer.validate(task, PortDM(TRAIN, VAL))


def test_any_other_accelerator_is_the_card():
    if torch.cuda.is_available():
        assert Trainer(accelerator="tpu").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Trainer(accelerator="tpu")
