"""The port's TensorBoard and W&B loggers against the JAX package's, on the CPU.

* Event files: the same logger calls go through the JAX ``TensorBoardLogger``
  (tensorboardX) and the port's (``utils/tfevents.py``); both files read by
  tensorboard's ``EventFileLoader``, which checks every CRC, give the same
  (tag, step, value, plugin, text) sequence (wall_time aside); each event's
  protobuf bytes equal tensorboardX's for the same wall time; a flipped bit
  fails the reader's CRC check.
* CRC32C: the port's masked CRC equals tensorboard's ``masked_crc32c`` on
  random bytes of many lengths.
* Audio: the WAV ``log_audio`` writes is byte-equal to the JAX logger's
  (which writes it where ``soundfile`` is absent, as here).
* W&B: the offline stub's JSONL equals the JAX stub's line for line.
"""
import json
import os
import socket

import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_file_loader import EventFileLoader
from tensorboard.compat.tensorflow_stub.errors import DataLossError, OutOfRangeError
from tensorboard.compat.tensorflow_stub.pywrap_tensorflow import (PyRecordReader_New,
                                                                   masked_crc32c)
from tensorboardX.proto.event_pb2 import Event
from tensorboardX.summary import scalar, text

from msla_tpu.train import loggers as jax_loggers
from msla_tpu_torch.train import loggers
from msla_tpu_torch.utils import tfevents

HPARAMS = {"learning_rate": 1e-4, "num_hidden": 128, "name": "vqvae", "tags": ["a", "b"],
           "path": os.sep.join(["x", "y"])}
CALLS = [({"train/loss": 1.5, "train/perplexity": 3.0}, 1),
         ({"train/loss": 0.0, "validation/si_sdr_bass": -12.25}, 2),
         ({"validation/loss": float("nan"), "odd name!": 1e-30, "/lead": 7.0}, 2),
         ({"train/loss": 1e300, "test/loss": -2.0}, 4)]


def _drive(module, logdir):
    lg = module.TensorBoardLogger(str(logdir), name="run", prefix="vqvae/")
    lg.log_hyperparams(HPARAMS)
    for metrics, step in CALLS:
        lg.log_metrics(metrics, step)
    lg.finalize()


def _read(logdir) -> list[tuple]:
    """Every event of every file of ``logdir`` as (file_version,) or (tag,
    step, value, plugin, text, shape, dtype), in file order."""
    out = []
    for path in sorted(logdir.glob("events.out.tfevents.*")):
        for event in EventFileLoader(str(path)).Load():
            if event.HasField("file_version"):
                out.append((event.file_version,))
            for v in event.summary.value:
                # the loader migrates simple_value to a scalars-plugin tensor
                value = v.tensor.float_val[0] if v.tensor.float_val else None
                texts = [t.decode() for t in v.tensor.string_val]
                out.append((v.tag, event.step, value, v.metadata.plugin_data.plugin_name,
                            texts, [d.size for d in v.tensor.tensor_shape.dim],
                            v.tensor.dtype))
    return out


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (np.isnan(a) and np.isnan(b))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def test_event_files_read_as_tensorboardx_writes_them(tmp_path):
    _drive(loggers, tmp_path / "port")
    _drive(jax_loggers, tmp_path / "jax")
    ours, theirs = _read(tmp_path / "port" / "run"), _read(tmp_path / "jax" / "run")
    assert len(ours) == len(theirs) == 1 + 1 + sum(len(m) for m, _ in CALLS)
    assert _same(ours, theirs)
    assert ours[0] == ("brain.Event:2",)
    tag, step, value, plugin, texts, shape, dtype = ours[1]
    assert (tag, step, plugin, shape, dtype) == ("hparams/text_summary", 0, "text", [1], 7)
    assert json.loads(texts[0]) == HPARAMS
    assert ours[-2][:3] == ("vqvae/train/loss", 4, float("inf"))  # 1e300 past fp32's range
    names = os.listdir(tmp_path / "port" / "run")
    assert len(names) == 1 and names[0].startswith("events.out.tfevents.")
    assert names[0].endswith("." + socket.gethostname())


@pytest.mark.parametrize("value", [0.0, 1.5, -2.25e-9, float("nan"), float("-inf")])
@pytest.mark.parametrize("step", [None, 0, 7, 2**40])
def test_events_are_tensorboardx_bytes(value, step):
    want = Event(summary=scalar("train/loss x", value), wall_time=1234.5)
    if step is not None:
        want.step = step
    got = tfevents.event(1234.5, step, values=(tfevents.scalar_value("train/loss x", value),))
    assert got == want.SerializeToString()
    body = '{\n  "a": "é"\n}'
    want = Event(summary=text("hparams", body), wall_time=1.0)
    assert tfevents.event(1.0, values=(tfevents.text_value("hparams", body),)) == \
        want.SerializeToString()
    want = Event(wall_time=99.0, file_version="brain.Event:2")
    assert tfevents.event(99.0, file_version="brain.Event:2") == want.SerializeToString()


def _records(path) -> int:
    """The records of a file, through tensorboard's reader, which checks both
    CRCs of each (the loader drops a record that fails)."""
    reader, n = PyRecordReader_New(str(path)), 0
    while True:
        try:
            reader.GetNext()
        except OutOfRangeError:
            return n
        n += 1


def test_a_flipped_bit_fails_the_crc_check(tmp_path):
    _drive(loggers, tmp_path)
    path, = (tmp_path / "run").glob("events.out.tfevents.*")
    assert _records(path) == 2 + sum(len(m) for m, _ in CALLS)
    data = bytearray(path.read_bytes())
    data[-10] ^= 0x04  # inside the last record's data
    path.write_bytes(bytes(data))
    with pytest.raises(DataLossError, match="failed event crc32 check"):
        _records(path)


def test_masked_crc32c_is_tensorboards():
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 3, 7, 8, 9, 31, 64, 255, 1000, 4099):
        for _ in range(3):
            data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            assert tfevents.masked_crc32c(data) == masked_crc32c(data), n
    assert tfevents.crc32c(b"123456789") == 0xE3069283  # CRC-32C's check value


def test_audio_is_the_jax_loggers_wav(tmp_path):
    rng = np.random.default_rng(1)
    audio = (rng.standard_normal(1000) * 0.4).astype(np.float32)
    for label, module in (("port", loggers), ("jax", jax_loggers)):
        lg = module.TensorBoardLogger(str(tmp_path / label))
        lg.log_audio("demo/bass vs D(bass)", audio, 22000, 3)
        lg.finalize()
    name = "demo_bass_vs_D(bass)_step3.wav"
    ours = (tmp_path / "port" / "audio" / name).read_bytes()
    assert ours == (tmp_path / "jax" / "audio" / name).read_bytes()
    lg = loggers.TensorBoardLogger(str(tmp_path / "tensor"))
    lg.log_audio("demo/bass vs D(bass)", torch.from_numpy(audio), 22000, 3)
    assert (tmp_path / "tensor" / "audio" / name).read_bytes() == ours


def test_wandb_stub_writes_the_jax_stubs_lines(tmp_path):
    audio = np.zeros((2, 500), np.float32)
    table = [["a.wav", tmp_path / "b.wav"], [1, 2.5]]
    for label, module in (("port", loggers), ("jax", jax_loggers)):
        lg = module.WandbLogger(name="BERT", project="DLAI_TRANSFORMERS",
                                save_dir=str(tmp_path / label), offline=False,
                                settings={"init_timeout": 300})
        lg.log_hyperparams(HPARAMS)
        for metrics, step in CALLS[:2]:
            lg.log_metrics(metrics, step)
        lg.log_table("DEMO EPOCH [0]", ["x", "y"], table)
        lg.log_audio("demo", audio, 22000, 2)
        lg.finalize()
    ours = (tmp_path / "port" / "wandb_stub.jsonl").read_text().splitlines()
    theirs = (tmp_path / "jax" / "wandb_stub.jsonl").read_text().splitlines()
    assert len(ours) == len(theirs) == 5
    assert ours == theirs
    assert [json.loads(line)["type"] for line in ours] == ["hparams", "metrics", "metrics",
                                                           "table", "audio"]
