"""The port's callbacks and CSV logger against the JAX package's.

* ModelCheckpoint and EarlyStopping driven by the same metric sequence as
  msla_tpu.train.callbacks' (a stand-in trainer writes each checkpoint as a
  small file naming its epoch): the same files with the same contents after
  every validation, the same links, ``best_model_path``/``best_model_score``,
  ``stop_training`` and ``state_dict``, also after a resume from that state.
* ``min_epochs`` and the logged steps through the two Trainers: a small
  VQVAETask with an EarlyStopping that asks to stop at once, and a CSVLogger;
  both stop at the same epoch, and their metrics.csv files have the same
  header and steps, the values within rtol 1e-3 (3 fp32 steps summed in
  another order, as tests/test_torch_train.py holds them).
* CSVLogger's files byte for byte against the JAX CSVLogger's for the same
  calls.
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from msla_tpu.models.vqvae import VQVAETask as JaxVQVAETask
from msla_tpu.train import callbacks as jax_callbacks
from msla_tpu.train import loggers as jax_loggers
from msla_tpu.train.trainer import Trainer as JaxTrainer
from msla_tpu_torch.train import callbacks, loggers
from msla_tpu_torch.train.trainer import Trainer
from test_torch_train import CFG, TRAIN, VAL, JaxDM, PortDM, _port_task


class StandIn:
    """What the callbacks need of a Trainer: save_checkpoint, here a small
    file naming the epoch that wrote it."""

    def __init__(self):
        self.current_epoch = 0

    def save_checkpoint(self, path, weights_only=False, background=False, wire=None):
        with open(path, "w") as f:
            f.write(f"epoch {self.current_epoch} weights_only {weights_only}")


def _files(d) -> dict:
    return {p.name: p.read_text() for p in sorted(d.iterdir())} if d.exists() else {}


def _named(state: dict) -> dict:
    """A ModelCheckpoint's state with its paths cut to file names."""
    out = dict(state, best=[[s, os.path.basename(p)] for s, p in state["best"]])
    if out["best_model_path"]:
        out["best_model_path"] = os.path.basename(out["best_model_path"])
    return out


def _same(a, b) -> bool:
    """Equal, NaN equal to NaN."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


SCORES = [1.0, 0.8, 0.9, 0.7, float("nan"), 0.75, 0.6, 0.6, 2.0]


@pytest.mark.parametrize("kw", [dict(), dict(save_top_k=1), dict(save_top_k=0),
                                dict(save_top_k=-1), dict(mode="max"), dict(save_last=False),
                                dict(save_weights_only=True, filename="best_vqvae")])
def test_model_checkpoint_matches_jax(tmp_path, kw):
    ours = callbacks.ModelCheckpoint(dirpath=tmp_path / "port", **kw)
    theirs = jax_callbacks.ModelCheckpoint(dirpath=str(tmp_path / "jax"), **kw)
    trainer = StandIn()

    def step(score):
        trainer.current_epoch += 1
        for cb in (ours, theirs):
            cb.on_validation_end(trainer, {"validation/loss": score, "train/loss": 0.0})
        assert _files(ours.dirpath) == _files(theirs.dirpath)
        assert _same(_named(ours.state_dict()), _named(theirs.state_dict()))
        assert ours.best_model_score == theirs.best_model_score
        if theirs.best_model_path:
            canonical = ours.dirpath / os.path.basename(theirs.best_model_path)
            assert ours.best_model_path == str(canonical)
            assert os.path.samefile(canonical, ours._best[0][1])  # a link, not a copy
        else:
            assert ours.best_model_path is None

    for score in SCORES[:5]:
        step(score)
    # a resume: fresh callbacks from the saved state go on as the old ones would
    state_ours, state_theirs = ours.state_dict(), theirs.state_dict()
    ours = callbacks.ModelCheckpoint(dirpath=tmp_path / "port", **kw)
    theirs = jax_callbacks.ModelCheckpoint(dirpath=str(tmp_path / "jax"), **kw)
    ours.load_state_dict(state_ours)
    theirs.load_state_dict(state_theirs)
    assert _same(_named(ours.state_dict()), _named(theirs.state_dict()))
    for score in SCORES[5:]:
        step(score)


def test_model_checkpoint_ignores_a_missing_monitor_and_refuses_wire(tmp_path):
    cb = callbacks.ModelCheckpoint(dirpath=tmp_path)
    cb.on_validation_end(StandIn(), {"train/loss": 1.0})
    assert not tmp_path.joinpath("last.ckpt").exists()
    for kw in (dict(wire="bf16"), dict(wire_best=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue item 2"):
            callbacks.ModelCheckpoint(dirpath=tmp_path, **kw)


NAN, INF = float("nan"), float("inf")


@pytest.mark.parametrize("kw,scores", [
    (dict(patience=2), [1.0, 0.9, 0.95, 0.92, 0.91, 0.5]),
    (dict(patience=2, min_delta=0.05), [1.0, 0.97, 0.9, 0.88, 0.86, 0.7]),
    (dict(patience=1, mode="max"), [0.1, 0.3, 0.2, 0.4]),
    (dict(patience=3), [1.0, NAN, 0.9]),
    (dict(patience=3), [1.0, INF, 0.9]),
    (dict(patience=2, check_finite=False), [1.0, NAN, NAN, 0.5]),
    (dict(patience=5, stopping_threshold=0.5), [1.0, 0.7, 0.5, 0.4]),
    (dict(patience=5, divergence_threshold=2.0), [1.0, 1.5, 2.0]),
    (dict(patience=5, mode="max", stopping_threshold=0.9, divergence_threshold=0.1),
     [0.5, 0.95]),
])
def test_early_stopping_matches_jax(kw, scores):
    ours, theirs = callbacks.EarlyStopping(**kw), jax_callbacks.EarlyStopping(**kw)
    for i, score in enumerate(scores):
        for cb in (ours, theirs):
            cb.on_validation_end(StandIn(), {"validation/loss": score})
        assert ours.stop_training == theirs.stop_training, i
        assert _same(ours.state_dict(), theirs.state_dict()), i
        if i == 1:  # a resume carries patience and the best score
            again = callbacks.EarlyStopping(**kw)
            again.load_state_dict(ours.state_dict())
            ours = again


@pytest.mark.parametrize("strict", [True, False])
def test_early_stopping_on_a_missing_monitor_as_jax(strict):
    ours = callbacks.EarlyStopping(strict=strict)
    theirs = jax_callbacks.EarlyStopping(strict=strict)
    for cb in (ours, theirs):
        if strict:
            with pytest.raises(RuntimeError, match="validation/loss"):
                cb.on_validation_end(StandIn(), {"train/loss": 1.0})
        else:
            cb.on_validation_end(StandIn(), {"train/loss": 1.0})
    assert ours.state_dict() == theirs.state_dict()


@pytest.fixture(scope="module")
def jax_params(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax")
    task = JaxVQVAETask(**CFG, checkpoint_dir=str(tmp), codebook_file=str(tmp / "cb.csv"))
    batch0 = JaxDM(TRAIN, VAL).on_after_batch_transfer(jnp.asarray(TRAIN[0]))
    return task.init_variables(jax.random.PRNGKey(0), batch0)["params"]


@pytest.mark.parametrize("min_epochs", [1, 2])
def test_min_epochs_and_logged_steps_match_the_jax_trainer(jax_params, tmp_path, min_epochs):
    """EarlyStopping asks to stop after the first validation; both Trainers
    stop once min_epochs are done, having logged each step and each epoch at
    the same global steps (a single logger, or a list of one)."""
    kw = dict(max_epochs=3, min_epochs=min_epochs, accelerator="cpu",
              enable_progress_bar=False, log_every_n_steps=2, seed=0)
    stop_now = dict(stopping_threshold=1e9)
    jax_task = JaxVQVAETask(**CFG, checkpoint_dir=str(tmp_path),
                            codebook_file=str(tmp_path / "cb.csv"))
    jax_trainer = JaxTrainer(default_root_dir=str(tmp_path), **kw,
                             callbacks=[jax_callbacks.EarlyStopping(**stop_now)],
                             logger=[jax_loggers.CSVLogger(str(tmp_path / "jax"))])
    jax_trainer.fit(jax_task, JaxDM(TRAIN, VAL))

    trainer = Trainer(default_root_dir=str(tmp_path), **kw,
                      callbacks=[callbacks.EarlyStopping(**stop_now)],
                      logger=loggers.CSVLogger(str(tmp_path / "port")))
    task = _port_task(jax_params, tmp_path / "task")
    trainer.fit(task, PortDM(TRAIN, VAL))
    assert trainer.current_epoch == jax_trainer.current_epoch == min_epochs
    assert trainer.global_step == jax_trainer.global_step == 3 * min_epochs

    def table(path):
        lines = path.read_text().splitlines()
        return lines[0].split(","), [[float(v) if v else None for v in line.split(",")]
                                     for line in lines[1:]]

    header, rows = table(tmp_path / "port" / "metrics.csv")
    want_header, want_rows = table(tmp_path / "jax" / "metrics.csv")
    assert header == want_header
    assert len(rows) == len(want_rows) == 3 * min_epochs // 2 + min_epochs  # steps, epochs
    for row, want in zip(rows, want_rows):
        assert row[0] == want[0]  # the step
        assert [v is None for v in row] == [v is None for v in want]
        np.testing.assert_allclose([v for v in row if v is not None],
                                   [v for v in want if v is not None], rtol=1e-3)


@pytest.mark.parametrize("name,prefix", [(None, ""), ("run", ""), ("run", "vqvae/")])
def test_csv_logger_writes_the_jax_bytes(tmp_path, name, prefix):
    calls = [({"train/loss": 1.5, "train/perplexity": 3.0}, 1),
             ({"train/loss": 1.25}, 2),
             ({"train/loss": 1.0, "validation/loss": 0.5, "validation/perplexity": 7}, 2),
             ({"validation/loss": float("nan")}, 3),
             ({"train/loss": 1e-9, "test/loss": -2.0}, 4)]
    for label, module in (("port", loggers), ("jax", jax_loggers)):
        lg = module.CSVLogger(str(tmp_path / label), name=name, prefix=prefix)
        lg.log_hyperparams({"learning_rate": 1e-4})
        for metrics, step in calls[:3]:
            lg.log_metrics(metrics, step)
        lg.finalize()
        # a second stage adopts the file's header, then grows it
        again = module.CSVLogger(str(tmp_path / label), name=name, prefix=prefix)
        for metrics, step in calls[3:]:
            again.log_metrics(metrics, step)
    path = ("run" if name else "") + "/metrics.csv"
    ours = (tmp_path / "port" / path.lstrip("/")).read_bytes()
    assert ours == (tmp_path / "jax" / path.lstrip("/")).read_bytes()
    assert ours.startswith(b"step,")


def test_tensorboard_logger_waits(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue item 2"):
        loggers.TensorBoardLogger(str(tmp_path))
