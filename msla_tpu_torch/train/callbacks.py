"""Training callbacks: ModelCheckpoint and EarlyStopping (port of
msla_tpu/train/callbacks.py, with the constructor keywords of
configs/callbacks/{model_checkpoint,early_stopping}.yaml).

ModelCheckpoint monitors ``validation/loss``, keeps the top-k checkpoints in
versioned files ``<filename>-v<n>.ckpt``, makes ``<filename>.ckpt`` a link to
the best of them (a copy where the file system takes no link), and writes
``last.ckpt`` on every validation. EarlyStopping stops on patience, a
non-finite score or a threshold. Both keep their state in ``state_dict`` so
that a resume from a checkpoint continues the patience count and the top-k
heap. ``wire`` writes ``last.ckpt`` in a smaller, approximate form (and the
versioned files too with ``wire_best``), as the JAX ModelCheckpoint does.
Every file is written in the background (``train/checkpoint.py``):
the versioned file and ``last.ckpt`` are copied when the validation ends and
written by the writer thread, the canonical link is queued behind its
file's write, a top-k file that is dropped is joined before it is removed,
and the Trainer's ``fit`` returns once all of them have landed, as the JAX
ModelCheckpoint does (msla_tpu/train/callbacks.py:106-156).

One departure from the JAX package (ROADMAP.md §3): ``last.ckpt`` is written
after the top-k update, and the Trainer runs checkpoint callbacks after the
others, as Lightning orders them, so ``last.ckpt`` holds every callback's
state after this validation. The JAX ModelCheckpoint writes it first, so its
resumed heap and patience lag one validation behind.
"""
from __future__ import annotations

import logging
import math
import os
from pathlib import Path
from typing import Mapping

from msla_tpu_torch.train.checkpoint import link_after_pending, wait_for_pending

log = logging.getLogger(__name__)


class Callback:
    def on_validation_end(self, trainer, metrics: Mapping[str, float]) -> None:
        pass

    def on_train_end(self, trainer) -> None:
        pass

    @property
    def stop_training(self) -> bool:
        return False

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state: dict) -> None:
        pass


class ModelCheckpoint(Callback):
    def __init__(self, dirpath: str, filename: str = "best", monitor: str = "validation/loss",
                 verbose: bool = False, save_last: bool = True, save_top_k: int = 2,
                 mode: str = "min", auto_insert_metric_name: bool = True,
                 save_weights_only: bool = False, every_n_train_steps=None,
                 train_time_interval=None, every_n_epochs=None,
                 save_on_train_epoch_end=None, wire: str | None = None,
                 wire_best: bool = False):
        """``auto_insert_metric_name``, ``every_n_*``, ``train_time_interval``
        and ``save_on_train_epoch_end`` are accepted at any value and read by
        nothing, as in the JAX package. ``wire`` ("bf16", "q8", …:
        ``train/checkpoint.py``) encodes ``last.ckpt``; the versioned files
        and the canonical best stay exact (wire "off", whatever
        ``MSLA_CKPT_WIRE`` says) unless ``wire_best``, since the later stages
        and exports read them."""
        self.wire = wire
        self.wire_best = wire_best
        self.dirpath = Path(dirpath)
        self.filename = filename
        self.monitor = monitor
        self.verbose = verbose
        self.save_last = save_last
        self.save_top_k = save_top_k
        self.mode = mode
        self.save_weights_only = save_weights_only
        self._best: list[tuple[float, str]] = []  # [(score, versioned path)], best first
        self._version = 0
        self.best_model_path: str | None = None
        self.best_model_score: float | None = None

    def state_dict(self) -> dict:
        return {"best": [[score, path] for score, path in self._best],
                "version": self._version,
                "best_model_path": self.best_model_path,
                "best_model_score": self.best_model_score}

    def load_state_dict(self, state: dict) -> None:
        # heap entries whose files are gone (a copied checkpoint) are dropped,
        # once a write in flight to them has landed
        for _, path in state.get("best", []):
            wait_for_pending(str(path))
        self._best = [(float(s), str(p)) for s, p in state.get("best", [])
                      if os.path.exists(str(p))]
        self._version = int(state.get("version", len(self._best)))
        self.best_model_path = state.get("best_model_path") or None
        score = state.get("best_model_score")
        self.best_model_score = float(score) if score is not None else None

    def _qualifies(self, score: float) -> bool:
        if self.save_top_k == 0:   # Lightning: save nothing (last.ckpt only)
            return False
        if self.save_top_k < 0:    # Lightning: save everything
            return True
        if len(self._best) < self.save_top_k:
            return True
        worst = self._best[-1][0]
        return score < worst if self.mode == "min" else score > worst

    def on_validation_end(self, trainer, metrics: Mapping[str, float]) -> None:
        if self.monitor not in metrics:
            return
        score = float(metrics[self.monitor])
        self.dirpath.mkdir(parents=True, exist_ok=True)
        if not math.isnan(score) and self._qualifies(score):
            self._save_top_k(trainer, score)
        if self.save_last:
            trainer.save_checkpoint(self.dirpath / "last.ckpt",
                                    weights_only=self.save_weights_only, background=True,
                                    wire=self.wire)

    def _save_top_k(self, trainer, score: float) -> None:
        """A versioned file for this score; the worst beyond k removed; the
        canonical ``<filename>.ckpt`` pointed at the best."""
        path = str(self.dirpath / f"{self.filename}-v{self._version}.ckpt")
        self._version += 1
        trainer.save_checkpoint(path, weights_only=self.save_weights_only, background=True,
                                wire=self.wire if self.wire_best else "off")
        self._best.append((score, path))
        self._best.sort(key=lambda t: t[0], reverse=(self.mode == "max"))
        if self.save_top_k > 0:  # negative keeps everything
            while len(self._best) > self.save_top_k:
                _, drop = self._best.pop()
                wait_for_pending(drop)  # a write in flight would bring it back
                if os.path.exists(drop):
                    os.remove(drop)
        canonical = str(self.dirpath / f"{self.filename}.ckpt")
        best_score, best_path = self._best[0]
        link_after_pending(best_path, canonical)
        self.best_model_path = canonical
        self.best_model_score = best_score
        if self.verbose:
            log.info("Saved checkpoint %s (score %.6f)", path, score)


class EarlyStopping(Callback):
    def __init__(self, monitor: str = "validation/loss", min_delta: float = 0.0,
                 patience: int = 5, verbose: bool = False, mode: str = "min",
                 strict: bool = True, check_finite: bool = True,
                 stopping_threshold=None, divergence_threshold=None,
                 check_on_train_epoch_end=None):
        """``check_on_train_epoch_end`` is accepted and read by nothing, as in
        the JAX package: the check runs after each validation."""
        self.monitor = monitor
        self.min_delta = float(min_delta)
        self.patience = int(patience)
        self.verbose = verbose
        self.mode = mode
        self.strict = strict
        self.check_finite = check_finite
        self.stopping_threshold = stopping_threshold
        self.divergence_threshold = divergence_threshold
        self._wait = 0
        self._best: float | None = None
        self._stop = False

    def state_dict(self) -> dict:
        return {"wait": self._wait, "best": self._best, "stopped": self._stop}

    def load_state_dict(self, state: dict) -> None:
        self._wait = int(state.get("wait", 0))
        best = state.get("best")
        self._best = float(best) if best is not None else None
        self._stop = bool(state.get("stopped", False))

    @property
    def stop_training(self) -> bool:
        return self._stop

    def _improved(self, score: float) -> bool:
        if self._best is None:
            return True
        if self.mode == "min":
            return score < self._best - self.min_delta
        return score > self._best + self.min_delta

    def _past(self, score: float, threshold, below_is_past: bool) -> bool:
        if threshold is None:
            return False
        return score <= threshold if below_is_past else score >= threshold

    def on_validation_end(self, trainer, metrics: Mapping[str, float]) -> None:
        if self.monitor not in metrics:
            if self.strict:
                raise RuntimeError(f"EarlyStopping: monitored metric '{self.monitor}' not "
                                   f"found in {sorted(metrics)}")
            return
        score = float(metrics[self.monitor])
        minimize = self.mode == "min"
        if self.check_finite and not math.isfinite(score):
            log.warning("EarlyStopping: %s is not finite (%s), stopping", self.monitor, score)
            self._stop = True
            return
        if self._past(score, self.stopping_threshold, minimize):
            self._stop = True
            return
        if self._past(score, self.divergence_threshold, not minimize):
            log.warning("EarlyStopping: %s diverged past %s", self.monitor,
                        self.divergence_threshold)
            self._stop = True
            return
        if self._improved(score):
            self._best = score
            self._wait = 0
            return
        self._wait += 1
        if self._wait >= self.patience:
            if self.verbose:
                log.info("EarlyStopping: no improvement in %d checks, stopping", self.patience)
            self._stop = True
