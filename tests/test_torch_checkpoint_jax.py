"""Checkpoints across the two packages, and the port's frozen sidecars, on the CPU.

* A JAX ``save_checkpoint`` of a VQ-VAE (with optax's Adam state) and of an
  Audio-BERT with ``frozen_keys`` (its ``frozen-<fp>.ckpt`` sidecar), read by
  the port's ``load_checkpoint``: the weights bit-equal to
  ``*_state_dict_from_jax`` of the saved params, the meta fields equal to what
  the JAX ``load_checkpoint`` returns; the JAX legacy ``frozen.ckpt`` name is
  honoured; a missing sidecar raises ``FileNotFoundError`` with JAX's message;
  a ``wire`` file decodes as the JAX ``load_checkpoint`` decodes it.
* The Trainer: ``validate``, ``test`` and ``predict`` take a JAX file's
  weights; ``fit(ckpt_path=<JAX file>)`` takes optax's Adam state too
  (tests/test_torch_resume_jax.py holds a resumed step against JAX's).
* The port's sidecars: the versioned files hold no ``bert.*`` or ``codebook``
  key; a second save of the same frozen content writes no second sidecar; a
  one-ulp change of one frozen element gives a new name; reassembly is exact,
  and the legacy name is honoured here too.
"""
import json
import shutil

import jax
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from msla_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from msla_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from msla_tpu_torch.train.checkpoint import (frozen_fingerprint, is_jax_file, load_checkpoint,
                                             restore_params, save_checkpoint)
from msla_tpu_torch.train.trainer import Trainer
from msla_tpu_torch.utils.jax_compat import (audio_bert_state_dict_from_jax,
                                             vqvae_state_dict_from_jax)
from test_torch_audio_bert import make_pair
from test_torch_train import CFG, VAL, PortDM, _paths, _port_task
from test_torch_train import jax_side  # noqa: F401  (the module fixture)

META = dict(epoch=2, global_step=7, hparams={"lr": 1e-4, "name": "x"},
            callback_metrics={"validation/loss": 0.5, "train/loss": 0.25},
            callbacks_state=[{"class": "EarlyStopping",
                              "state": {"wait": 1, "best": 0.5, "stopped": False}}])
FROZEN = ("bert", "codebook")


def _equal_state(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def _same_meta(got, want):
    for k in ("epoch", "global_step", "hparams", "callback_metrics", "callbacks"):
        assert got[k] == want[k], k


def test_a_jax_vqvae_checkpoint_reads_bit_equal(jax_side, tmp_path):
    _, params = jax_side
    opt_state = optax.adam(1e-4).init(params)
    path = tmp_path / "vqvae.ckpt"
    jax_save_checkpoint(path, params=params, opt_state=opt_state, **META)
    assert is_jax_file(path)
    payload = load_checkpoint(path)
    assert payload["format"] == "jax"
    _same_meta(payload, jax_load_checkpoint(path))
    task = _port_task(params, tmp_path)
    _equal_state(restore_params(path, task),
                 vqvae_state_dict_from_jax(jax.device_get(params), CFG["num_residual_layer"]))


def _jax_bert_checkpoint(tmp_path, **kw):
    jax_task, params, task = make_pair(tmp_path, 1000)
    path = tmp_path / "best" / "bert.ckpt"
    jax_save_checkpoint(path, params=params, opt_state=None, frozen_keys=FROZEN, **META, **kw)
    return params, task, path


def test_a_jax_audio_bert_checkpoint_with_its_sidecar(tmp_path):
    params, task, path = _jax_bert_checkpoint(tmp_path)
    raw = serialization.msgpack_restore(path.read_bytes())
    assert raw["frozen_file"].startswith("frozen-") and set(raw["state_dict"]) == {"head"}
    payload = load_checkpoint(path)
    _same_meta(payload, jax_load_checkpoint(path))
    want = audio_bert_state_dict_from_jax(jax.device_get(params))
    _equal_state(restore_params(path, task), want)
    task.net.load_state_dict(restore_params(path, task))  # strict

    # the JAX package's legacy sidecar name
    (path.parent / raw["frozen_file"]).rename(path.parent / "frozen.ckpt")
    raw["frozen_file"] = "frozen.ckpt"
    path.write_bytes(serialization.msgpack_serialize(raw))
    _equal_state(restore_params(path, task), want)

    (path.parent / "frozen.ckpt").unlink()
    with pytest.raises(FileNotFoundError, match="references frozen sidecar .* which is missing"):
        load_checkpoint(path)


def test_a_wire_file_reads_as_jax_reads_it(tmp_path):
    """A wired Audio-BERT file with its (exact) sidecar: the weights the
    JAX ``load_checkpoint`` decodes, bit for bit, through the task."""
    params, task, path = _jax_bert_checkpoint(tmp_path, wire="bf16")
    raw = serialization.msgpack_restore(path.read_bytes())
    assert raw["wire"] == "bf16" and raw["state_dict"]["head"]["linear"]["dense"]["kernel"][
        "__wire__"] == "bf16"
    want = jax_load_checkpoint(path)
    payload = load_checkpoint(path)
    _same_meta(payload, want)
    assert "wire" not in payload
    _equal_state(restore_params(path, task), audio_bert_state_dict_from_jax(want["state_dict"]))
    exact = audio_bert_state_dict_from_jax(jax.device_get(params))
    got = restore_params(path, task)
    assert torch.equal(got["bert.bert.embeddings.word_embeddings.weight"],
                       exact["bert.bert.embeddings.word_embeddings.weight"])  # the sidecar
    assert torch.equal(got["head.linear.weight"],
                       exact["head.linear.weight"].to(torch.bfloat16).float())


class EvalDM(PortDM):
    def test_dataloader(self):
        return list(self.val)

    def predict_dataloader(self):
        return [b[:1] for b in self.val]


def test_the_trainer_takes_a_jax_files_weights_and_adam_state(jax_side, tmp_path):
    """validate, test and predict take the weights; fit takes optax's Adam
    too: each parameter's mu and nu in the port's layout, its count as the
    step, and goes on from the file's step."""
    _, params = jax_side
    path = tmp_path / "vqvae.ckpt"
    tx = optax.adam(1e-4)
    rng = np.random.default_rng(5)
    grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    _, opt_state = tx.update(grads, tx.init(params), params)
    jax_save_checkpoint(path, params=params, opt_state=opt_state, **META)
    want = vqvae_state_dict_from_jax(jax.device_get(params), CFG["num_residual_layer"])
    dm = EvalDM(VAL, VAL)
    for entry in ("validate", "test", "predict"):
        task = _port_task(params, tmp_path)
        for p in task.net.parameters():  # other weights, so the load shows
            torch.nn.init.zeros_(p)
        trainer = Trainer(accelerator="cpu", enable_progress_bar=False)
        out = getattr(trainer, entry)(task, dm, ckpt_path=str(path))
        _equal_state(task.net.state_dict(), want)
        assert trainer.global_step == META["global_step"] and out, entry
    trainer = Trainer(accelerator="cpu", enable_progress_bar=False, max_epochs=3)
    task = _port_task(params, tmp_path)
    trainer._setup(task, dm)
    trainer._restore(path)
    mu, nu = (vqvae_state_dict_from_jax(jax.device_get(getattr(opt_state[0], k)),
                                        CFG["num_residual_layer"]) for k in ("mu", "nu"))
    names = [name for name, _ in task.net.named_parameters()]
    state = trainer._optimizer.state_dict()["state"]
    assert sorted(state) == list(range(len(names)))
    for i, name in enumerate(names):
        assert state[i]["step"].item() == 1
        assert torch.equal(state[i]["exp_avg"], mu[name]), name
        assert torch.equal(state[i]["exp_avg_sq"], nu[name]), name
    trainer.fit(task, dm, ckpt_path=str(path))
    assert (trainer.global_step, trainer.current_epoch) == (META["global_step"] + 2, 3)
    assert trainer._optimizer.state_dict()["state"][0]["step"].item() == 3


def _sidecars(d):
    return sorted(p.name for p in d.glob("frozen-*.ckpt"))


def test_port_sidecars_once_per_content_and_exact(tmp_path):
    _, _, task = make_pair(tmp_path, 1000)
    sd = task.net.state_dict()
    d = tmp_path / "ckpt"
    save_checkpoint(d / "a.ckpt", state_dict=sd, frozen_keys=FROZEN, **META)
    raw = torch.load(d / "a.ckpt", weights_only=True)
    assert sorted(raw["state_dict"]) == ["head.conv.bias", "head.conv.weight",
                                         "head.linear.bias", "head.linear.weight"]
    assert json.loads(raw["frozen_keys"]) == list(FROZEN)
    first, = _sidecars(d)
    assert raw["frozen_file"] == first
    stamp = (d / first).stat().st_mtime_ns
    side = torch.load(d / first, weights_only=True)["state_dict"]
    assert all(k.startswith("bert.") or k == "codebook" for k in side)

    save_checkpoint(d / "b.ckpt", state_dict=sd, frozen_keys=FROZEN)
    assert _sidecars(d) == [first] and (d / first).stat().st_mtime_ns == stamp
    _equal_state(load_checkpoint(d / "a.ckpt")["state_dict"], sd)
    _same_meta(load_checkpoint(d / "a.ckpt"), {**META, "callbacks": META["callbacks_state"]})

    # one element one ulp away: another name, and each file keeps its own content
    changed = dict(sd)
    w = sd["bert.bert.encoder.layer.0.output.dense.weight"].clone()
    w[3, 5] = torch.nextafter(w[3, 5], torch.tensor(np.inf))
    changed["bert.bert.encoder.layer.0.output.dense.weight"] = w
    assert frozen_fingerprint({"w": w}) != frozen_fingerprint(
        {"w": sd["bert.bert.encoder.layer.0.output.dense.weight"]})
    save_checkpoint(d / "c.ckpt", state_dict=changed, frozen_keys=FROZEN)
    assert len(_sidecars(d)) == 2
    _equal_state(load_checkpoint(d / "c.ckpt")["state_dict"], changed)
    _equal_state(load_checkpoint(d / "a.ckpt")["state_dict"], sd)

    # the legacy name, in the port's own format
    payload = torch.load(d / "a.ckpt", weights_only=True)
    shutil.copyfile(d / first, d / "frozen.ckpt")
    payload["frozen_file"] = "frozen.ckpt"
    torch.save(payload, d / "legacy.ckpt")
    _equal_state(load_checkpoint(d / "legacy.ckpt")["state_dict"], sd)
    (d / first).unlink()
    with pytest.raises(FileNotFoundError, match="which is missing"):
        load_checkpoint(d / "b.ckpt")
