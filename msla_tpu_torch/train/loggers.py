"""Metric loggers (port of msla_tpu/train/loggers.py:23-40, :79-169).

``CSVLogger`` writes ``<save_dir>/<name>/metrics.csv`` as the JAX package's
does: a ``step`` column, then each metric's column in the order it first
appeared; the header is rewritten when a new metric appears, and an existing
file's header is adopted, so one file can span stages. The same calls give
the same bytes. ``TensorBoardLogger`` waits: no configuration this port runs
uses it.
"""
from __future__ import annotations

import csv
from pathlib import Path
from typing import Any, Mapping


class Logger:
    """Base logger interface."""

    def log_metrics(self, metrics: Mapping[str, float], step: int) -> None:
        raise NotImplementedError

    def log_hyperparams(self, params: Mapping[str, Any]) -> None:
        pass

    def finalize(self, status: str = "success") -> None:
        pass


class TensorBoardLogger(Logger):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError("TensorBoardLogger is not ported yet: ROADMAP.md queue "
                                  "item 2 (the rest of the trainer)")


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
