"""The Trainer's test loop, anomaly mode, simple profiler and the audio demo
on the CPU.

* ``Trainer.test`` against the JAX ``Trainer.test`` on the same weights (the
  JAX Trainer's own init, carried by ``vqvae_state_dict_from_jax``): every
  test metric at rtol 1e-5, atol 1e-5 (one forward's conv stacks summed in
  another order, batch-size-weighted means), with ``limit_test_batches`` as a
  count and as a fraction; ``ckpt_path`` "best", "last" and a path restore
  the saved weights before testing;
* ``detect_anomaly=True`` raises on a planted NaN in a train batch (the
  backward that makes it), leaves anomaly mode as it found it, and without
  it the same fit runs to its end;
* ``profiler="simple"`` logs its wall-clock report when ``fit`` ends;
* the audio demo of the first validation batch writes the JAX package's WAV
  names when the trainer has a logger and hands each logger the table; a
  logger that fails there does not stop training, but a failing forward
  raises.
"""
import logging

import jax
import numpy as np
import pytest
import torch

from msla_tpu.data.datamodule import SlakhDataModule as JaxSlakhDataModule
from msla_tpu.models.vqvae import VQVAETask as JaxVQVAETask
from msla_tpu.train.trainer import Trainer as JaxTrainer
from msla_tpu_torch.data.datamodule import SlakhDataModule
from msla_tpu_torch.data.wavio import read_wav
from msla_tpu_torch.models.vqvae import VQVAETask
from msla_tpu_torch.train.callbacks import ModelCheckpoint
from msla_tpu_torch.train.checkpoint import load_checkpoint
from msla_tpu_torch.train.loggers import CSVLogger, Logger
from msla_tpu_torch.train.trainer import Trainer
from msla_tpu_torch.utils.jax_compat import vqvae_state_dict_from_jax

CFG = dict(num_hidden=16, num_residual_layer=2, num_residual_hidden=8, num_embedding=16,
           embedding_dim=8, commitment_cost=0.25, learning_rate=1e-4, sample_rate=1000)
B, T = 2, 800
DM_ARGS = dict(train_dir="t", val_dir="v", test_dir="s", target_sample_rate=1000,
               target_sample_duration=2, max_duration=120, maximum_dataset_size=100,
               batch_size=B)


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, 4, T)) * 0.3).astype(np.float32) for _ in range(n)]


TRAIN, VAL, TEST = _batches(2, 0), _batches(2, 1), _batches(3, 2)


def _loaders(cls):
    class InMemory(cls):
        def __init__(self, train=TRAIN, val=VAL, test=TEST):
            super().__init__(**DM_ARGS)
            self.train, self.val, self.test = train, val, test

        def train_dataloader(self):
            return list(self.train)

        def val_dataloader(self):
            return list(self.val)

        def test_dataloader(self):
            return list(self.test)

    return InMemory


JaxDM, PortDM = _loaders(JaxSlakhDataModule), _loaders(SlakhDataModule)


def _paths(tmp):
    return dict(checkpoint_dir=str(tmp), codebook_file=str(tmp / "codebook.csv"))


def _port_task(tmp, params=None, seed=0):
    task = VQVAETask(**CFG, **_paths(tmp), device="cpu", seed=seed)
    if params is not None:
        task.net.load_state_dict(vqvae_state_dict_from_jax(params, CFG["num_residual_layer"]))
    return task


@pytest.mark.parametrize("limit,batches", [(1.0, 3), (2, 2), (0.5, 1)])
def test_test_matches_the_jax_trainer(tmp_path, limit, batches):
    jax_task = JaxVQVAETask(**CFG, **_paths(tmp_path / "jax"))
    jax_trainer = JaxTrainer(accelerator="cpu", enable_progress_bar=False, seed=0,
                             limit_test_batches=limit)
    want = jax_trainer.test(jax_task, JaxDM())
    params = jax.device_get(jax_trainer.state.params)

    trainer = Trainer(accelerator="cpu", enable_progress_bar=False, limit_test_batches=limit)
    got = trainer.test(_port_task(tmp_path, params), PortDM())
    assert trainer._limit(len(TEST), limit) == batches
    assert set(got) == set(want) and len(got) == 19 and all(k.startswith("test/") for k in got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5, err_msg=k)
    assert {k: trainer.callback_metrics[k] for k in got} == got


def test_test_restores_best_last_or_a_path(tmp_path):
    dm = PortDM()
    task = _port_task(tmp_path)
    checkpoint = ModelCheckpoint(dirpath=str(tmp_path / "ckpt"), filename="best_vqvae")
    trainer = Trainer(accelerator="cpu", enable_progress_bar=False, max_epochs=2,
                      callbacks=[checkpoint])
    trainer.fit(task, dm)
    trained = trainer.test(task, dm)
    last = tmp_path / "ckpt" / "last.ckpt"
    for ckpt_path, saved in (("last", last), (str(last), last),
                             ("best", checkpoint.best_model_path)):
        fresh = _port_task(tmp_path, seed=7)
        metrics = Trainer(accelerator="cpu", enable_progress_bar=False,
                          callbacks=[checkpoint]).test(fresh, dm, ckpt_path=ckpt_path)
        want = load_checkpoint(saved)["state_dict"]
        assert all(torch.equal(v, want[k]) for k, v in fresh.net.state_dict().items())
        if saved == last:
            assert metrics == trained, ckpt_path


def _nan_dm():
    bad = [t.copy() for t in TRAIN]
    bad[1][0, 2, 100] = np.nan
    return PortDM(train=bad)


def test_detect_anomaly_raises_on_a_planted_nan(tmp_path):
    trainer = Trainer(accelerator="cpu", enable_progress_bar=False, max_epochs=1,
                      detect_anomaly=True)
    with pytest.raises(RuntimeError, match="nan"):
        trainer.fit(_port_task(tmp_path), _nan_dm())
    assert not torch.is_anomaly_enabled()
    plain = Trainer(accelerator="cpu", enable_progress_bar=False, max_epochs=1)
    plain.fit(_port_task(tmp_path), _nan_dm())
    assert plain.global_step == 2 and np.isnan(plain.callback_metrics["train/loss"])


def test_simple_profiler_logs_its_report(tmp_path, caplog):
    trainer = Trainer(accelerator="cpu", enable_progress_bar=False, max_epochs=1,
                      profiler="simple")
    with caplog.at_level(logging.INFO, logger="msla_tpu_torch.train.trainer"):
        trainer.fit(_port_task(tmp_path), PortDM())
    report = [r.getMessage() for r in caplog.records if "Profiler report" in r.getMessage()]
    assert len(report) == 1
    for section, calls in (("train_step", 2), ("validation_step", 2), ("validation", 1)):
        line = next(ln for ln in report[0].splitlines() if ln.split()[:1] == [section])
        assert f"calls {calls:5d}" in line, line
    quiet = Trainer(accelerator="cpu", enable_progress_bar=False, max_epochs=1)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="msla_tpu_torch.train.trainer"):
        quiet.fit(_port_task(tmp_path), PortDM())
    assert not any("Profiler report" in r.getMessage() for r in caplog.records)


class _TableLogger(Logger):
    def __init__(self, fail=False):
        self.tables, self.fail = [], fail

    def log_metrics(self, metrics, step):
        pass

    def log_table(self, key, columns, data):
        if self.fail:
            raise OSError("no room for the table")
        self.tables.append((key, columns, data))


def test_audio_demo_writes_the_jax_wavs_and_tables(tmp_path):
    table = _TableLogger()
    trainer = Trainer(accelerator="cpu", enable_progress_bar=False, max_epochs=1,
                      logger=[CSVLogger(str(tmp_path / "csv")), table])
    trainer.fit(_port_task(tmp_path / "demo"), PortDM())
    names = [f"{kind}_{n}.wav" for kind in ("original", "generated")
             for n in ("bass", "drums", "guitar", "piano", "full_song")]
    for name in names:
        audio, rate = read_wav(tmp_path / "demo" / name)
        assert rate == CFG["sample_rate"] and audio.shape == (1, T)
    (key, columns, data), = table.tables
    assert key == "DEMO EPOCH [0]" and len(columns) == 5
    assert data[0][-1].endswith("original_full_song.wav")
    assert data[1][0].endswith("generated_bass.wav")


def test_audio_demo_guards_only_the_writes(tmp_path, caplog):
    trainer = Trainer(accelerator="cpu", enable_progress_bar=False, max_epochs=1,
                      logger=[_TableLogger(fail=True)])
    with caplog.at_level(logging.WARNING, logger="msla_tpu_torch.models.demo"):
        trainer.fit(_port_task(tmp_path), PortDM())
    assert trainer.current_epoch == 1
    assert any("on validation batch end" in r.getMessage() for r in caplog.records)

    task = _port_task(tmp_path)
    original = task.net.forward
    calls = []

    def failing(x):  # the demo's forward: the third of the validation forwards
        calls.append(x.shape[0])
        if x.shape[0] == 1:
            raise RuntimeError("kernel launch failed")
        return original(x)

    task.net.forward = failing
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        Trainer(accelerator="cpu", enable_progress_bar=False, max_epochs=1,
                logger=[_TableLogger()]).fit(task, PortDM())
    assert 1 in calls


def test_no_logger_no_demo(tmp_path):
    Trainer(accelerator="cpu", enable_progress_bar=False, max_epochs=1).fit(
        _port_task(tmp_path), PortDM())
    assert not list(tmp_path.glob("*.wav"))
