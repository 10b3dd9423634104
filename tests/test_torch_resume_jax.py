"""``fit(ckpt_path=<a JAX .ckpt>)`` on the CPU against the JAX Trainer's own
resume, for the VQ-VAE, the transformer (dropout 0) and Audio-BERT (frozen
BERT and codebook, ``mask_prob`` 0), each at the small size of its test file.

The JAX Trainer fits 2 epochs of a step with a ModelCheckpoint and an
EarlyStopping and writes ``last.ckpt``; then the JAX Trainer and the port's
each resume one step from it on the same third batch. The port:

* restores the callbacks' state by class name (the JAX file keeps the
  config's order, ModelCheckpoint first; the port runs it last);
* maps optax's state onto torch's: Adam's ``count`` / ``mu`` / ``nu`` (AdamW's
  under ``multi_transform``'s "train" label for Audio-BERT, whose frozen
  parts have none) to ``step`` / ``exp_avg`` / ``exp_avg_sq``;
* restores the file's moments bit for bit in its own layout, and the count;
* ends at JAX's step count, with each moment within 1e-5 of its tensor's
  largest of JAX's (the transformer's attention query and key projections
  within 1e-3: their gradients are near-cancelling sums at these weights;
  its key bias, whose gradient is 0 in exact arithmetic, not compared), and
  each parameter's move from the checkpoint within
  0.2·lr of JAX's where the resumed step's gradient is clear of 0 (as the
  test files hold 3 ``fit`` steps); frozen weights bit-unchanged.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import test_torch_bert_train as bert_t
import test_torch_train as vq_t
import test_torch_transformer as tr_t
from msla_tpu.train.callbacks import EarlyStopping as JaxEarlyStopping
from msla_tpu.train.callbacks import ModelCheckpoint as JaxModelCheckpoint
from msla_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from msla_tpu.train.trainer import Trainer as JaxTrainer
from msla_tpu_torch.train.callbacks import EarlyStopping, ModelCheckpoint
from msla_tpu_torch.train.trainer import Trainer
from msla_tpu_torch.utils.jax_compat import audio_bert_head_state_dict_from_jax
from test_torch_bert_train import side  # noqa: F401  (module fixtures)
from test_torch_train import jax_side  # noqa: F401
from test_torch_transformer import teacher  # noqa: F401

QUIET = dict(accelerator="cpu", enable_progress_bar=False, log_every_n_steps=0, seed=0)


def _callbacks(ckpt_dir, jax: bool):
    if jax:
        return [JaxModelCheckpoint(str(ckpt_dir), filename="best"), JaxEarlyStopping(patience=5)]
    return [ModelCheckpoint(str(ckpt_dir), filename="best"), EarlyStopping(patience=5)]


def _resume(root, jax_task, jax_dm, port_task, port_dm, to_port, adam_of, grad_at, lr, clear,
            frozen=(), moment_tol=None):
    """JAX: 2 steps, last.ckpt, 1 resumed step; the port: the resumed step.
    ``moment_tol`` maps parts of parameter names to their moments' tolerance
    (of the largest), None to skip."""
    moment_tol = moment_tol or {}
    first = JaxTrainer(default_root_dir=str(root), max_epochs=2,
                       callbacks=_callbacks(root / "jax", True), **QUIET)
    first.fit(jax_task, jax_dm(0, 1))  # 2 epochs of a step: callbacks with a state
    last = root / "jax" / "last.ckpt"
    resumed = JaxTrainer(default_root_dir=str(root), max_epochs=3,
                         callbacks=_callbacks(root / "jax2", True), **QUIET)
    resumed.fit(jax_task, jax_dm(2, 3), ckpt_path=str(last))
    assert resumed.global_step == 3

    saved = jax_load_checkpoint(last)
    trainer = Trainer(max_epochs=3, callbacks=_callbacks(root / "port", False), **QUIET)
    trainer._setup(port_task, port_dm(2, 3))
    trainer._restore(last)
    by_class = {entry["class"]: entry["state"] for entry in saved["callbacks"]}
    assert [e["class"] for e in saved["callbacks"]] == ["ModelCheckpoint", "EarlyStopping"]
    assert [type(cb).__name__ for cb in trainer.callbacks] == ["EarlyStopping",
                                                                "ModelCheckpoint"]
    for cb in trainer.callbacks:
        assert cb.state_dict() == by_class[type(cb).__name__]
    # the JAX ModelCheckpoint writes last.ckpt first: its heap, and the patience
    # of the EarlyStopping after it, are those of the first validation
    assert trainer.callbacks[1].state_dict()["version"] == 1
    assert trainer.callbacks[0].state_dict()["best"] == by_class["EarlyStopping"]["best"] > 0
    assert torch.equal(trainer._generator.get_state(),
                       torch.Generator().manual_seed(1).get_state())
    count, mu, nu = adam_of(saved["opt_state"])  # the file's moments, in the port's layout
    names = {id(p): name for name, p in port_task.net.named_parameters()}
    assert len(trainer._optimizer.state) == len(mu) > 0
    for p, s in trainer._optimizer.state.items():
        assert s["step"].item() == int(count) == 2
        assert torch.equal(s["exp_avg"], mu[names[id(p)]]), names[id(p)]
        assert torch.equal(s["exp_avg_sq"], nu[names[id(p)]]), names[id(p)]
    trainer.fit(port_task, port_dm(2, 3), ckpt_path=str(last))
    assert (trainer.global_step, trainer.current_epoch) == (3, 3)

    start = to_port(saved["state_dict"])
    want_sd = to_port(jax.device_get(resumed.state.params))
    grads = grad_at(saved["state_dict"])
    for key, value in port_task.net.state_dict().items():
        if key.split(".")[0] in frozen:
            assert torch.equal(value, start[key]), key
            continue
        g = grads[key].abs()
        sure = g > clear * g.max()
        assert sure.any(), key
        moved, want_moved = value - start[key], want_sd[key] - start[key]
        np.testing.assert_allclose(moved[sure].numpy(), want_moved[sure].numpy(), rtol=0,
                                   atol=0.2 * lr, err_msg=key)

    count, mu, nu = adam_of(serialization.to_state_dict(jax.device_get(
        resumed.state.opt_state)))
    state = trainer._optimizer.state
    assert len(state) == len(mu)
    for p, s in state.items():
        name = names[id(p)]
        assert s["step"].item() == int(count) == 3, name
        tol = next((t for part, t in moment_tol.items() if part in name), 1e-5)
        if tol is None:
            continue
        for got, want in ((s["exp_avg"], mu[name]), (s["exp_avg_sq"], nu[name])):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=tol * want.abs().max().item(), err_msg=name)


def test_vqvae_resumes_from_a_jax_file(jax_side, tmp_path):
    jax_task, params = jax_side
    to_port = lambda p: vq_t.vqvae_state_dict_from_jax(p, vq_t.CFG["num_residual_layer"])  # noqa
    task = vq_t._port_task(params, tmp_path / "task")
    batch = vq_t.JaxDM(vq_t.TRAIN, vq_t.VAL).on_after_batch_transfer(jnp.asarray(vq_t.TRAIN[2]))
    grad = lambda p: to_port(jax.grad(  # noqa: E731
        lambda q: jax_task.loss_fn(q, batch, jax.random.PRNGKey(0))[0])(p))
    adam = lambda s: (s["0"]["count"], to_port(s["0"]["mu"]), to_port(s["0"]["nu"]))  # noqa
    _resume(tmp_path, jax_task, lambda a, b: vq_t.JaxDM(vq_t.TRAIN[a:b], vq_t.VAL), task,
            lambda a, b: vq_t.PortDM(vq_t.TRAIN[a:b], vq_t.VAL), to_port, adam, grad,
            vq_t.CFG["learning_rate"], 1e-3)


def _train_slice(cls, a, b):
    class Sliced(cls):
        def train_dataloader(self):
            return list(tr_t.TRAIN[a:b])
    return Sliced


def test_transformer_resumes_from_a_jax_file(teacher, tmp_path):
    jax_task, params, task = tr_t._tasks(teacher)
    batch = tr_t._batch(teacher, tr_t.TRAIN[2])[0]
    grad = lambda p: task.state_dict_from_jax(jax.device_get(jax.grad(  # noqa: E731
        lambda q: jax_task.loss_fn(q, batch, jax.random.PRNGKey(0))[0])(p)))
    adam = lambda s: (s["0"]["count"], task.state_dict_from_jax(s["0"]["mu"]),  # noqa: E731
                      task.state_dict_from_jax(s["0"]["nu"]))
    # The self-attention's query and key gradients part by up to 8e-4 of their
    # largest between the packages at these weights (attention near uniform),
    # so their moments by up to 7.9e-5 of theirs. The key bias's gradient is 0
    # in exact arithmetic (a shift shared by all keys leaves the softmax as it
    # is): both packages hold rounding there, which is not compared.
    _resume(tmp_path, jax_task,
            lambda a, b: _train_slice(tr_t.JaxDM, a, b)(quantizer=teacher["jax"]), task,
            lambda a, b: _train_slice(tr_t.PortDM, a, b)(quantizer=teacher["port"]),
            task.state_dict_from_jax, adam, grad, tr_t.LR, 1e-2,
            moment_tol={"self_attn.k_proj.bias": None, "self_attn.q_proj": 1e-3,
                        "self_attn.k_proj": 1e-3})


def test_audio_bert_resumes_from_a_jax_file(side, tmp_path):
    jax_task = bert_t._jax_task(side["root"], mask_prob=0.0)
    task = bert_t._port_task(side, mask_prob=0.0)
    ids = bert_t._ids(side, bert_t.TRAIN[2])
    batch = (jnp.asarray(ids), jnp.asarray(bert_t.TRAIN[2]))
    grad = lambda p: task.state_dict_from_jax(jax.device_get(jax.grad(  # noqa: E731
        lambda q: jax_task.loss_fn(q, batch, jax.random.PRNGKey(0))[0])(p)))

    def adam(state):
        inner = state["inner_states"]["train"]["inner_state"]["0"]
        return (inner["count"], audio_bert_head_state_dict_from_jax(inner["mu"]["head"]),
                audio_bert_head_state_dict_from_jax(inner["nu"]["head"]))

    quantize = bert_t._port_quantize(side)
    _resume(tmp_path, jax_task,
            lambda a, b: bert_t.JaxDM(bert_t.TRAIN[a:b], bert_t.VAL, quantizer=side["jax_q"]),
            task, lambda a, b: bert_t.PortDM(bert_t.TRAIN[a:b], bert_t.VAL, quantizer=quantize),
            task.state_dict_from_jax, adam, grad, bert_t.LR, 1e-3, frozen=("bert", "codebook"))
