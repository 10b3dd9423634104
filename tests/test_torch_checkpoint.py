"""Checkpoints of the port (msla_tpu_torch.train.checkpoint, Trainer.save_checkpoint
and ``ckpt_path``), on the CPU.

* A checkpoint is one ``torch.save`` file that ``torch.load(weights_only=True)``
  reads, with the JAX package's payload keys (held against a checkpoint the
  JAX ``save_checkpoint`` writes) plus the per-step generator's state; its
  state_dict has the network's reference key names and values, its opt_state
  loads into Adam, its hparams are the task's keywords.
* A ``fit`` split by ``ckpt_path="last"`` ends where an uninterrupted ``fit``
  ends, masking on (so the generator's draws count): the same parameters and
  Adam state bit for bit, the same metrics, callbacks' state and CSV bytes.
* ``ckpt_path="best"`` and a path restore in ``validate``; "last" without a
  ModelCheckpoint raises.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from msla_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from msla_tpu_torch.train.callbacks import EarlyStopping, ModelCheckpoint
from msla_tpu_torch.train.checkpoint import load_checkpoint
from msla_tpu_torch.train.loggers import CSVLogger
from msla_tpu_torch.train.trainer import Trainer
from test_torch_train import PortDM, _batches, _port_task
from test_torch_train import jax_side  # noqa: F401  (the module fixture)

MASKED_TRAIN, MASKED_VAL = _batches(2, 30, t=4000), _batches(1, 31, t=4000)


def _run(params, root, max_epochs, ckpt_path=None):
    """Trainer.fit with the large_batch run's callbacks and CSV logger under
    ``root``; returns (trainer, task)."""
    task = _port_task(params, root / "task")
    trainer = Trainer(default_root_dir=str(root), max_epochs=max_epochs, accelerator="cpu",
                      enable_progress_bar=False, log_every_n_steps=1, seed=0,
                      callbacks=[ModelCheckpoint(dirpath=str(root / "ckpt"), filename="best"),
                                 EarlyStopping(patience=5)],
                      logger=[CSVLogger(str(root / "csv"))])
    trainer.fit(task, PortDM(MASKED_TRAIN, MASKED_VAL, masking=True), ckpt_path=ckpt_path)
    return trainer, task


def test_checkpoint_round_trip_under_weights_only_load(jax_side, tmp_path):
    _, params = jax_side
    trainer, task = _run(params, tmp_path, max_epochs=1)
    path = tmp_path / "ckpt" / "last.ckpt"
    raw = torch.load(path, weights_only=True)

    jax_path = tmp_path / "jax.ckpt"
    jax_save_checkpoint(jax_path, params={"w": jnp.zeros(2)}, opt_state={"m": jnp.zeros(2)},
                        epoch=1, global_step=2, hparams={"a": 1}, callback_metrics={"x": 1.0},
                        callbacks_state=[])
    jax_keys = set(serialization.msgpack_restore(jax_path.read_bytes()))
    assert set(raw) == jax_keys | {"generator"}

    assert (raw["epoch"], raw["global_step"]) == (1, 2)
    assert json.loads(raw["hparams"]) == task.hparams
    assert raw["callback_metrics"] == trainer.callback_metrics
    assert [c["class"] for c in json.loads(raw["callbacks"])] == ["EarlyStopping",
                                                                   "ModelCheckpoint"]
    sd = task.net.state_dict()
    assert list(raw["state_dict"]) == list(sd)
    for key, value in sd.items():
        assert torch.equal(raw["state_dict"][key], value), key
    adam = task.configure_optimizer()
    adam.load_state_dict(raw["opt_state"])
    assert adam.state_dict()["state"][0]["step"].item() == 2

    payload = load_checkpoint(path)
    assert payload["hparams"] == task.hparams and payload["callbacks"][1]["state"]["version"] == 1
    trainer.save_checkpoint(tmp_path / "weights.ckpt", weights_only=True)
    assert torch.load(tmp_path / "weights.ckpt", weights_only=True)["opt_state"] == {}


def test_fit_split_by_last_ends_where_one_fit_ends(jax_side, tmp_path):
    _, params = jax_side
    whole, whole_task = _run(params, tmp_path / "whole", max_epochs=3)
    _run(params, tmp_path / "split", max_epochs=1)
    split, split_task = _run(params, tmp_path / "split", max_epochs=3, ckpt_path="last")

    assert (split.global_step, split.current_epoch) == (whole.global_step, whole.current_epoch)
    for key, value in whole_task.net.state_dict().items():
        assert torch.equal(split_task.net.state_dict()[key], value), key
    want_adam, got_adam = whole._optimizer.state_dict(), split._optimizer.state_dict()
    for i, state in want_adam["state"].items():
        for name, value in state.items():
            assert torch.equal(got_adam["state"][i][name], value), (i, name)
    assert split.callback_metrics == whole.callback_metrics
    early, checkpoints = split.callbacks  # checkpoint callbacks run last
    assert early.state_dict() == whole.callbacks[0].state_dict()
    names = lambda cb: [(s, p.split("/")[-1]) for s, p in cb.state_dict()["best"]]  # noqa: E731
    assert names(checkpoints) == names(whole.callbacks[1]) and len(names(checkpoints)) == 2
    assert checkpoints.state_dict()["version"] == whole.callbacks[1].state_dict()["version"] == 3
    whole_csv = (tmp_path / "whole" / "csv" / "metrics.csv").read_bytes()
    assert (tmp_path / "split" / "csv" / "metrics.csv").read_bytes() == whole_csv


def test_validate_restores_best_or_a_path_and_last_needs_a_checkpoint(jax_side, tmp_path):
    _, params = jax_side
    trainer, task = _run(params, tmp_path, max_epochs=2)
    cb = trainer.callbacks[-1]
    best = torch.load(cb.best_model_path, weights_only=True)["state_dict"]
    with torch.no_grad():
        for p in task.net.parameters():
            p.add_(1.0)
    trainer.validate(task, PortDM(MASKED_TRAIN, MASKED_VAL), ckpt_path="best")
    for key, value in task.net.state_dict().items():
        assert torch.equal(value, best[key]), key
    first = torch.load(tmp_path / "ckpt" / "best-v0.ckpt", weights_only=True)
    metrics = trainer.validate(task, PortDM(MASKED_TRAIN, MASKED_VAL),
                               ckpt_path=str(tmp_path / "ckpt" / "best-v0.ckpt"))
    assert trainer.global_step == first["global_step"] == 2
    np.testing.assert_allclose(metrics["validation/loss"],
                               first["callback_metrics"]["validation/loss"], rtol=1e-6)

    bare = Trainer(accelerator="cpu", enable_progress_bar=False)
    with pytest.raises(RuntimeError, match="no ModelCheckpoint"):
        bare.fit(task, PortDM(MASKED_TRAIN, MASKED_VAL), ckpt_path="last")
    with pytest.raises(RuntimeError, match="call fit or validate first"):
        Trainer(accelerator="cpu").save_checkpoint(tmp_path / "x.ckpt")


def test_loaded_checkpoint_resumes_on_the_generator_it_saved(jax_side, tmp_path):
    """The per-step generator comes back with the weights: the masks a
    resumed step draws are those the uninterrupted run drew."""
    _, params = jax_side
    trainer, _ = _run(params, tmp_path, max_epochs=1)
    saved = load_checkpoint(tmp_path / "ckpt" / "last.ckpt")["generator"]
    assert torch.equal(saved, trainer._generator.get_state())
    assert not torch.equal(saved, torch.Generator().manual_seed(1).get_state())
