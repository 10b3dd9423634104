"""Background checkpoint writes (``train/checkpoint.py``) on the CPU.

* ModelCheckpoint with the writes in flight (the port's writer held back
  while each validation's callback runs) against the JAX ModelCheckpoint,
  which writes in the background too, on one metric sequence: the same
  files holding the same epochs, the same links and the same scores.
* A write followed by an in-place change of the weights and of Adam's
  moments before the write lands saves the values from before the change.
* A reader (``load_checkpoint``) of a file in flight waits for it, also for
  a frozen sidecar written in the background; a failed write raises once at
  ``wait_for_pending``; a link queued behind its source's write.
* ``Trainer.fit`` returns with no write pending, the writer slowed down.
* Threads that write, link, wait and read at once, more than the cores,
  with a short switch interval: every file ends with its last write.
"""
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from msla_tpu.train import callbacks as jax_callbacks
from msla_tpu.train import checkpoint as jax_checkpoint
from msla_tpu_torch.models.vqvae import VQVAETask
from msla_tpu_torch.train import callbacks, checkpoint
from msla_tpu_torch.train.checkpoint import (link_after_pending, load_checkpoint,
                                             save_checkpoint, wait_for_pending)
from msla_tpu_torch.train.trainer import Trainer
from test_torch_callbacks import SCORES
from test_torch_train import CFG, TRAIN, VAL, PortDM, _paths


@pytest.fixture
def held():
    """A gate that holds the writer thread back until it is opened."""
    gate = threading.Event()

    def hold():
        checkpoint._submit(gate.wait)

    yield gate, hold
    gate.set()
    wait_for_pending()


class Writer:
    """What the callbacks need of a Trainer: a save_checkpoint that writes
    the epoch through one package's background writer."""

    def __init__(self, jax: bool):
        self.jax, self.current_epoch = jax, 0

    def save_checkpoint(self, path, weights_only=False, background=False, wire=None):
        epoch = np.full(3, self.current_epoch, np.float32)
        if self.jax:
            jax_checkpoint.save_checkpoint(path, params={"epoch": epoch}, epoch=self.current_epoch,
                                           background=background, wire=wire)
        else:
            save_checkpoint(path, state_dict={"epoch": torch.from_numpy(epoch)},
                            epoch=self.current_epoch, background=background)


def _listing(d, load):
    return {p.name: load(p)["epoch"] for p in sorted(d.iterdir())}


def test_model_checkpoint_in_flight_matches_jax(tmp_path, held):
    gate, hold = held
    ours = callbacks.ModelCheckpoint(dirpath=tmp_path / "port")
    theirs = jax_callbacks.ModelCheckpoint(dirpath=str(tmp_path / "jax"))
    port, jax_writer = Writer(jax=False), Writer(jax=True)
    for score in SCORES:
        port.current_epoch += 1
        jax_writer.current_epoch += 1
        gate.clear()
        hold()
        ours.on_validation_end(port, {"validation/loss": score})
        assert checkpoint.is_pending(ours.dirpath / "last.ckpt")  # written in the background
        gate.set()
        wait_for_pending()
        theirs.on_validation_end(jax_writer, {"validation/loss": score})
        jax_checkpoint.wait_for_pending()
        assert _listing(ours.dirpath, load_checkpoint) == _listing(
            tmp_path / "jax", jax_checkpoint.load_checkpoint)
        assert ours.best_model_score == theirs.best_model_score
        assert [s for s, _ in ours._best] == [s for s, _ in theirs._best]
        if theirs.best_model_path:
            assert os.path.basename(ours.best_model_path) == os.path.basename(
                theirs.best_model_path)
            assert os.path.samefile(ours.best_model_path, ours._best[0][1])


def test_a_snapshot_keeps_the_values_from_before_an_in_place_change(tmp_path, held):
    gate, hold = held
    w = torch.randn(64, 64, requires_grad=True)
    opt = torch.optim.Adam([w], lr=0.1)
    (w * w).sum().backward()
    opt.step()
    before = w.detach().clone()
    moment = opt.state[w]["exp_avg"].clone()
    hold()
    save_checkpoint(tmp_path / "a.ckpt", state_dict={"w": w}, opt_state=opt.state_dict(),
                    background=True)
    opt.step()  # in place, while the write waits
    with torch.no_grad():
        w.add_(1.0)
    assert not torch.equal(w.detach(), before)
    gate.set()
    payload = load_checkpoint(tmp_path / "a.ckpt")
    assert torch.equal(payload["state_dict"]["w"], before)
    assert torch.equal(payload["opt_state"]["state"][0]["exp_avg"], moment)


def test_a_reader_waits_for_the_write_in_flight(tmp_path, held):
    gate, hold = held
    hold()
    frozen = {"bert.w": torch.arange(6.0), "head.w": torch.ones(2)}
    save_checkpoint(tmp_path / "b.ckpt", state_dict=frozen, frozen_keys=("bert",),
                    background=True)
    got = {}
    reader = threading.Thread(target=lambda: got.update(load_checkpoint(tmp_path / "b.ckpt")))
    reader.start()
    time.sleep(0.3)
    assert reader.is_alive() and not (tmp_path / "b.ckpt").exists()
    assert len(list(tmp_path.glob("frozen-*.ckpt*"))) == 0  # the sidecar waits in order too
    gate.set()
    reader.join(timeout=30)
    assert not reader.is_alive()
    assert torch.equal(got["state_dict"]["bert.w"], frozen["bert.w"])
    assert len(list(tmp_path.glob("frozen-*.ckpt"))) == 1


def test_a_link_waits_for_its_source(tmp_path, held):
    gate, hold = held
    hold()
    save_checkpoint(tmp_path / "v0.ckpt", state_dict={"x": torch.ones(3)}, background=True)
    link_after_pending(tmp_path / "v0.ckpt", tmp_path / "best.ckpt")
    assert not (tmp_path / "best.ckpt").exists()
    gate.set()
    wait_for_pending(tmp_path / "best.ckpt")
    assert os.path.samefile(tmp_path / "best.ckpt", tmp_path / "v0.ckpt")


def test_a_failed_write_raises_once(tmp_path):
    (tmp_path / "file").write_text("not a directory")
    save_checkpoint(tmp_path / "file" / "c.ckpt", state_dict={"x": torch.ones(1)},
                    background=True)
    with pytest.raises(OSError):
        wait_for_pending()
    wait_for_pending()  # raised once
    save_checkpoint(tmp_path / "c.ckpt", state_dict={"x": torch.ones(1)}, background=True)
    wait_for_pending(tmp_path / "c.ckpt")
    assert torch.equal(load_checkpoint(tmp_path / "c.ckpt")["state_dict"]["x"], torch.ones(1))


def test_fit_returns_with_no_write_pending(tmp_path, monkeypatch):
    write = checkpoint._write_file

    def slow(path, payload):
        time.sleep(0.2)
        return write(path, payload)

    monkeypatch.setattr(checkpoint, "_write_file", slow)
    cb = callbacks.ModelCheckpoint(dirpath=tmp_path / "ckpt", filename="best")
    trainer = Trainer(max_epochs=2, accelerator="cpu", enable_progress_bar=False,
                      log_every_n_steps=0, seed=0, callbacks=[cb])
    trainer.fit(VQVAETask(**CFG, **_paths(tmp_path / 'task'), device="cpu"),
                PortDM(TRAIN, VAL))
    assert not checkpoint._pending
    assert {p.name for p in cb.dirpath.iterdir()} == \
        {"best.ckpt", "last.ckpt"} | {os.path.basename(p) for _, p in cb._best}
    assert load_checkpoint(cb.dirpath / "last.ckpt")["epoch"] == 2


def test_threads_writing_and_waiting_at_once(tmp_path):
    def worker(i):
        for n in range(4):
            path = tmp_path / f"w{i % 3}.ckpt"  # three paths shared by the threads
            save_checkpoint(path, state_dict={"x": torch.full((8,), float(n))},
                            global_step=n, background=True)
            link_after_pending(path, tmp_path / f"link{i}.ckpt")
            if n % 2:
                wait_for_pending(path)
                assert load_checkpoint(path)["state_dict"]["x"].shape == (8,)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(2 * os.cpu_count())]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    wait_for_pending()
    assert not checkpoint._pending
    for i in range(3):  # each thread's last write to a path is a step-3 write
        payload = load_checkpoint(tmp_path / f"w{i}.ckpt")
        assert payload["global_step"] == 3
        assert torch.equal(payload["state_dict"]["x"], torch.full((8,), 3.0))
