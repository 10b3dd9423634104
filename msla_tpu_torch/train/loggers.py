"""Metric loggers (port of msla_tpu/train/loggers.py).

``CSVLogger`` writes ``<save_dir>/<name>/metrics.csv`` as the JAX package's
does: a ``step`` column, then each metric's column in the order it first
appeared; the header is rewritten when a new metric appears, and an existing
file's header is adopted, so one file can span stages. The same calls give
the same bytes; like the JAX CSVLogger it ignores the audio demo's
``log_table`` and ``log_audio``.

``TensorBoardLogger`` writes ``<save_dir>/<name>/events.out.tfevents.*``
through the port's own event writer (``utils/tfevents.py``): each metric a
scalar at its step, the hparams as JSON text. Its ``log_audio`` writes
``<logdir>/audio/<key>_step<step>.wav``, what the JAX logger does wherever
``soundfile`` is absent; the port never writes an audio summary (ROADMAP.md
§3).

``WandbLogger`` is the JAX logger's offline stub: ``wandb_stub.jsonl`` in
``save_dir`` with the same ``metrics``, ``hparams``, ``table`` and ``audio``
records. The port never imports ``wandb`` (ROADMAP.md §3); the JAX logger
goes online where it is installed.
"""
from __future__ import annotations

import csv
import json
import logging
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from msla_tpu_torch.data.wavio import write_wav
from msla_tpu_torch.utils.tfevents import EventFileWriter

log = logging.getLogger(__name__)


def _numpy(audio) -> np.ndarray:
    if isinstance(audio, torch.Tensor):
        return audio.detach().cpu().numpy()
    return np.asarray(audio)


class Logger:
    """Base logger interface."""

    def log_metrics(self, metrics: Mapping[str, float], step: int) -> None:
        raise NotImplementedError

    def log_hyperparams(self, params: Mapping[str, Any]) -> None:
        pass

    def log_audio(self, key: str, audio, sample_rate: int, step: int) -> None:
        pass

    def log_table(self, key: str, columns: list[str], data: list[list[Any]]) -> None:
        pass

    def finalize(self, status: str = "success") -> None:
        pass


class TensorBoardLogger(Logger):
    """TensorBoard event files (reference: configs/logger/tensorboard.yaml).
    ``log_graph`` and ``default_hp_metric`` are accepted and read by nothing,
    as in the JAX package."""

    def __init__(self, save_dir: str, name: str | None = None, log_graph: bool = False,
                 default_hp_metric: bool = True, prefix: str = ""):
        logdir = Path(save_dir) / (name or "")
        logdir.mkdir(parents=True, exist_ok=True)
        self.logdir = logdir
        self._writer = EventFileWriter(logdir)
        self._prefix = prefix

    def log_metrics(self, metrics: Mapping[str, float], step: int) -> None:
        for key, value in metrics.items():
            self._writer.add_scalar(self._prefix + key, float(value), step)

    def log_hyperparams(self, params: Mapping[str, Any]) -> None:
        self._writer.add_text("hparams", json.dumps(dict(params), default=str, indent=2))

    def log_audio(self, key: str, audio, sample_rate: int, step: int) -> None:
        out = self.logdir / "audio"
        out.mkdir(parents=True, exist_ok=True)
        safe = key.replace("/", "_").replace(" ", "_")
        write_wav(out / f"{safe}_step{step}.wav", _numpy(audio), sample_rate)

    def finalize(self, status: str = "success") -> None:
        self._writer.close()


class CSVLogger(Logger):
    """Append-only CSV metrics log."""

    def __init__(self, save_dir: str, name: str | None = None, prefix: str = ""):
        logdir = Path(save_dir) / (name or "")
        logdir.mkdir(parents=True, exist_ok=True)
        self._path = logdir / "metrics.csv"
        self._prefix = prefix
        self._fields: list[str] = []
        if self._path.exists():  # adopt the schema of an earlier stage's log
            with open(self._path) as f:
                header = f.readline().strip()
            if header:
                self._fields = header.split(",")

    def log_metrics(self, metrics: Mapping[str, float], step: int) -> None:
        row = {"step": step}
        row.update({self._prefix + k: float(v) for k, v in metrics.items()})
        new_fields = [f for f in row if f not in self._fields]
        if new_fields:  # rewrite the file under the grown header
            self._fields += new_fields
            rows = []
            if self._path.exists():
                with open(self._path) as f:
                    rows = list(csv.DictReader(f))
            with open(self._path, "w", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=self._fields)
                writer.writeheader()
                writer.writerows(rows)
        with open(self._path, "a", newline="") as f:
            csv.DictWriter(f, fieldnames=self._fields).writerow(row)


class WandbLogger(Logger):
    """The W&B surface (reference: configs/logger/wandb.yaml) as the JAX
    logger's offline stub: one JSON record a line."""

    def __init__(self, name: str = None, project: str = None, save_dir: str = ".",
                 log_model: bool = False, offline: bool = False, version: str = None,
                 settings: Mapping | None = None):
        self._save_dir = Path(save_dir)
        self._save_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = self._save_dir / "wandb_stub.jsonl"
        log.info("wandb is not used by the port — logging to %s", self._jsonl)

    def _emit(self, record: dict) -> None:
        with open(self._jsonl, "a") as f:
            f.write(json.dumps(record, default=str) + "\n")

    def log_metrics(self, metrics: Mapping[str, float], step: int) -> None:
        self._emit({"type": "metrics", "step": step,
                    "data": {k: float(v) for k, v in metrics.items()}})

    def log_hyperparams(self, params: Mapping[str, Any]) -> None:
        self._emit({"type": "hparams", "data": dict(params)})

    def log_table(self, key: str, columns: list[str], data: list[list[Any]]) -> None:
        self._emit({"type": "table", "key": key, "columns": columns,
                    "data": [[str(c) for c in row] for row in data]})

    def log_audio(self, key: str, audio, sample_rate: int, step: int) -> None:
        self._emit({"type": "audio", "key": key, "step": step,
                    "samples": int(_numpy(audio).size), "sample_rate": sample_rate})
