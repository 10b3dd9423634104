"""Training loop (port of msla_tpu/train/trainer.py: fit and validate).

The constructor takes the JAX Trainer's keywords. What this slice runs:
``fit`` and ``validate`` (each with ``ckpt_path``), ``save_checkpoint``;
``max_epochs``, ``min_epochs``, ``limit_train_batches``, ``limit_val_batches``,
``fast_dev_run``, ``log_every_n_steps``, ``enable_progress_bar``,
``default_root_dir``, ``callbacks``, ``logger``, ``precision`` and ``seed``;
epoch metrics as batch-size-weighted means of the per-batch means (Lightning's
``on_epoch`` reduction), in ``callback_metrics``. A keyword whose feature waits
for a later slice raises ``NotImplementedError`` naming its ROADMAP.md item
when it is given anything but its default.

One train step, in the order of the JAX step (msla_tpu/train/trainer.py:
354-406): ``datamodule.train_transform`` (the masking augment) →
``datamodule.on_after_batch_transfer`` (the mixture broadcast) →
``model.loss_fn`` → backward → the optimizer's step. On the card nothing in
the loop waits for the device: batches are copied one step ahead from pinned
memory on a side stream, and metrics stay device tensors until the epoch ends
(or until a logged step, ``log_every_n_steps``, reads them).

Around the epochs, as the JAX Trainer (msla_tpu/train/trainer.py:448-577):
the loggers get the task's hparams once per ``fit``, each logged step's
metrics and, after each validation, the epoch's; then ``current_epoch``
counts the epoch and the callbacks' ``on_validation_end`` runs (checkpoint
callbacks last, so that ``last.ckpt`` holds the others' state: ROADMAP.md §3);
training stops once a callback asks and ``min_epochs`` are done.
``ckpt_path`` is a path, "last" or "best" (resolved through the
ModelCheckpoint callback) and restores the weights, Adam's state, the epoch,
the global step, the per-step generator and the callbacks' state.

``accelerator="cpu"`` trains on the CPU; any other value on the card, which
must be present. The task must already live on that device. ``seed`` seeds
the generator of the per-step random draws (the augment's masks); the
weights' init is seeded where the task is built.
"""
from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Iterable, Iterator, Mapping

import torch

from msla_tpu_torch.device import resolve_device
from msla_tpu_torch.ops.conv_adjoints import fp32_convs
from msla_tpu_torch.train.callbacks import ModelCheckpoint
from msla_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

log = logging.getLogger(__name__)

_REST_OF_TRAINER = "ROADMAP.md queue item 2 (the rest of the trainer)"
_PARALLEL = "ROADMAP.md queue item 7 (the opt-ins: parallel/)"


def _refuse(name: str, value, default, item: str) -> None:
    if value != default:
        raise NotImplementedError(f"Trainer {name}={value!r} is not ported yet: {item}")


class Trainer:
    def __init__(self,
                 default_root_dir: str = ".",
                 min_epochs: int = 1,
                 max_epochs: int = 10,
                 enable_progress_bar: bool = True,
                 log_every_n_steps: int | None = 1000,
                 accelerator: str = "gpu",
                 devices: int = -1,
                 callbacks: list | None = None,
                 logger: list | None = None,
                 fast_dev_run: bool = False,
                 detect_anomaly: bool = False,
                 profiler: str | None = None,
                 limit_train_batches: float = 1.0,
                 limit_val_batches: float = 1.0,
                 limit_test_batches: float = 1.0,
                 num_nodes: int = 1,
                 accumulate_grad_batches: int = 1,
                 model_parallel: int = 1,
                 pipeline_parallel: int = 1,
                 pipeline_microbatches: int = 2,
                 zero1: bool = False,
                 fsdp: bool = False,
                 remat: bool = False,
                 precision: str = "medium",
                 seed: int = 0):
        """``precision`` sets only the matmul precision of the JAX Trainer's
        XLA passes (msla_tpu/train/trainer.py:120-125), and bf16 training
        comes from the task's ``compute_dtype``: the port runs fp32 with TF32
        off at every value, at least as precise as each TPU mapping ("high"
        and unknown strings as "medium"). ``devices``: -1 or 1, one card.
        ``default_root_dir`` is kept as the JAX Trainer keeps it: only its
        profiler trace, which waits, would be written there.
        ``limit_test_batches`` (``test``) and ``pipeline_microbatches`` wait
        with the features that read them."""
        _refuse("limit_test_batches", limit_test_batches, 1.0, _REST_OF_TRAINER)
        _refuse("detect_anomaly", detect_anomaly, False, _REST_OF_TRAINER)
        _refuse("profiler", profiler, None, _REST_OF_TRAINER)
        _refuse("accumulate_grad_batches", accumulate_grad_batches, 1, _REST_OF_TRAINER)
        _refuse("remat", remat, False, _REST_OF_TRAINER)
        for name, value, default in (("model_parallel", model_parallel, 1),
                                     ("pipeline_parallel", pipeline_parallel, 1),
                                     ("pipeline_microbatches", pipeline_microbatches, 2),
                                     ("zero1", zero1, False), ("fsdp", fsdp, False),
                                     ("num_nodes", num_nodes, 1)):
            _refuse(name, value, default, _PARALLEL)
        if devices not in (-1, 1, None):
            _refuse("devices", devices, 1, _PARALLEL)

        self.default_root_dir = Path(default_root_dir)
        self.min_epochs = int(min_epochs or 0)
        self.max_epochs = int(max_epochs)
        self.enable_progress_bar = enable_progress_bar
        self.log_every_n_steps = log_every_n_steps or 0
        self.fast_dev_run = fast_dev_run
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.seed = seed
        # checkpoint callbacks run last, so last.ckpt holds the others' state
        self.callbacks = sorted(callbacks or [], key=lambda cb: isinstance(cb, ModelCheckpoint))
        self.loggers = list(logger) if isinstance(logger, (list, tuple)) else \
            ([logger] if logger else [])
        self.device = resolve_device("cpu" if accelerator == "cpu" else "cuda")
        if self.device.type == "cuda":  # as a task's parameters report it
            self.device = torch.device("cuda", torch.cuda.current_device())

        self.callback_metrics: dict[str, float] = {}
        self.current_epoch = 0
        self.global_step = 0
        self._model = None
        self._optimizer: torch.optim.Optimizer | None = None
        self._generator: torch.Generator | None = None
        self._copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    # ---- checkpoint plumbing ---------------------------------------------------------
    def save_checkpoint(self, path, weights_only: bool = False) -> None:
        """One .ckpt file (``train/checkpoint.py``) of the task's weights,
        Adam's state (unless ``weights_only``, Lightning's
        ``save_weights_only``), the epoch, the global step, the per-step
        generator and the callbacks' state."""
        if self._model is None:
            raise RuntimeError("save_checkpoint needs a task: call fit or validate first")
        save_checkpoint(path,
                        state_dict=self._model.net.state_dict(),
                        opt_state=None if weights_only else self._optimizer.state_dict(),
                        epoch=self.current_epoch, global_step=self.global_step,
                        hparams=getattr(self._model, "hparams", {}),
                        callback_metrics=self.callback_metrics,
                        callbacks_state=[{"class": type(cb).__name__, "state": cb.state_dict()}
                                         for cb in self.callbacks],
                        generator_state=self._generator.get_state())

    def _resolve_ckpt_path(self, ckpt_path):
        """Lightning's meaning: "best" and "last" resolve through the
        ModelCheckpoint callback; None keeps the current weights."""
        if ckpt_path not in ("best", "last"):
            return ckpt_path
        for cb in self.callbacks:
            if isinstance(cb, ModelCheckpoint):
                if ckpt_path == "best" and cb.best_model_path:
                    return cb.best_model_path
                last = cb.dirpath / "last.ckpt"
                if ckpt_path == "last" and last.exists():
                    return str(last)
        raise RuntimeError(f"ckpt_path='{ckpt_path}' requested but no ModelCheckpoint "
                           "callback has a saved checkpoint")

    def _restore(self, ckpt_path) -> None:
        payload = load_checkpoint(ckpt_path)
        self._model.net.load_state_dict(payload["state_dict"])
        if payload.get("opt_state"):
            self._optimizer.load_state_dict(payload["opt_state"])
        if "generator" in payload:
            self._generator.set_state(payload["generator"])
        self.current_epoch = int(payload.get("epoch", 0))
        self.global_step = int(payload.get("global_step", 0))
        # callbacks by position, guarded by class name, as the JAX Trainer
        for cb, entry in zip(self.callbacks, payload.get("callbacks") or []):
            if type(cb).__name__ == entry.get("class"):
                cb.load_state_dict(entry.get("state", {}))
        log.info("Restored checkpoint %s (epoch %d, step %d)", ckpt_path, self.current_epoch,
                 self.global_step)

    def _log(self, metrics: Mapping[str, float], step: int) -> None:
        for lg in self.loggers:
            lg.log_metrics(metrics, step)

    # ---- loop helpers --------------------------------------------------------------
    @staticmethod
    def _limit(n_batches: int, fraction_or_count) -> int:
        if fraction_or_count is None:
            return n_batches
        if isinstance(fraction_or_count, float) and fraction_or_count <= 1.0:
            return max(1, int(n_batches * fraction_or_count))
        return min(n_batches, int(fraction_or_count))

    def _setup(self, model) -> None:
        if model.device != self.device:
            raise ValueError(f"the task lives on {model.device} and the Trainer runs on "
                             f"{self.device}: build the task with device={str(self.device)!r}")
        if self._model is not model:
            self._model = model
            self._optimizer = model.configure_optimizer()
            self._generator = torch.Generator(device=self.device).manual_seed(self.seed + 1)

    def _prefetched(self, loader: Iterable, max_batches: int) -> Iterator[tuple[int, torch.Tensor]]:
        """Yield (rows, device batch), the next batch's copy in flight meanwhile.

        On the card each batch goes to pinned memory and then, on a side
        stream, to the device; the step that consumes it waits for that copy
        alone (an event), so the copy overlaps the previous step's kernels.
        """
        pending = None
        for batch_idx, raw in enumerate(loader):
            if batch_idx >= max_batches:
                break
            staged = self._stage(raw)
            if pending is not None:
                yield self._ready(*pending)
            pending = staged
        if pending is not None:
            yield self._ready(*pending)

    def _stage(self, raw):
        host = torch.as_tensor(raw, dtype=torch.float32)
        if self._copy_stream is None:
            return host, None
        with torch.cuda.stream(self._copy_stream):
            dev = host.pin_memory().to(self.device, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self._copy_stream)
        return dev, copied

    def _ready(self, batch: torch.Tensor, copied) -> tuple[int, torch.Tensor]:
        if copied is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(copied)
            batch.record_stream(stream)  # allocated on the copy stream, used here
        return batch.shape[0], batch

    def _train_step(self, model, datamodule, raw: torch.Tensor) -> dict[str, torch.Tensor]:
        transform = getattr(datamodule, "train_transform", None)
        if transform is not None:
            raw = transform(raw, self._generator)
        batch = datamodule.on_after_batch_transfer(raw)
        self._optimizer.zero_grad(set_to_none=True)
        loss, metrics = model.loss_fn(batch, self._generator)
        with fp32_convs():  # the convs' adjoints run here, outside the forward's scope
            loss.backward()
        self._optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    @staticmethod
    def _accumulate(sums: dict, metrics: Mapping[str, torch.Tensor], rows: int) -> None:
        for k, v in metrics.items():  # device tensors: no wait for the device here
            sums[k] = sums[k] + v * rows if k in sums else v * rows

    @staticmethod
    def _means(sums: dict, rows: int) -> dict[str, float]:
        """Epoch means as host floats, in one transfer, in sorted key order as
        the JAX Trainer's jitted steps return them (so logged columns match)."""
        if not sums:
            return {}
        keys = sorted(sums)
        values = torch.stack([sums[k].float() for k in keys]).tolist()
        return {k: v / max(rows, 1) for k, v in zip(keys, values)}

    @torch.no_grad()
    def _run_eval(self, model, datamodule, loader, mode: str, limit) -> dict[str, float]:
        sums: dict = {}
        rows = 0
        max_batches = self._limit(len(loader), 1 if self.fast_dev_run else limit)
        for n, raw in self._prefetched(loader, max_batches):
            metrics = model.eval_metrics(datamodule.on_after_batch_transfer(raw), mode)
            self._accumulate(sums, metrics, n)
            rows += n
        return self._means(sums, rows)

    # ---- public API --------------------------------------------------------------
    def fit(self, model, datamodule, ckpt_path: str | None = None) -> None:
        train_loader = datamodule.train_dataloader()
        val_loader = datamodule.val_dataloader()
        if len(train_loader) == 0:
            raise RuntimeError("empty train dataloader — check data_dir and batch_size")
        self._setup(model)
        ckpt_path = self._resolve_ckpt_path(ckpt_path)
        if ckpt_path:
            self._restore(ckpt_path)
        for lg in self.loggers:
            lg.log_hyperparams(getattr(model, "hparams", {}))

        max_epochs = 1 if self.fast_dev_run else self.max_epochs
        stop = False
        while self.current_epoch < max_epochs and not stop:
            sums: dict = {}
            rows = 0
            max_batches = self._limit(len(train_loader),
                                      1 if self.fast_dev_run else self.limit_train_batches)
            t_epoch = time.perf_counter()
            for n, raw in self._prefetched(train_loader, max_batches):
                metrics = self._train_step(model, datamodule, raw)
                self.global_step += 1
                rows += n
                self._accumulate(sums, metrics, n)
                if self.log_every_n_steps and self.global_step % self.log_every_n_steps == 0:
                    self._log_step(metrics)
            train_epoch = self._means(sums, rows)
            self.callback_metrics.update(train_epoch)

            val_metrics = self._run_eval(model, datamodule, val_loader, "validation",
                                         self.limit_val_batches)
            self.callback_metrics.update(val_metrics)
            self._log({**train_epoch, **val_metrics}, self.global_step)
            if self.enable_progress_bar:
                log.info("epoch %d done in %.1fs: validation/loss=%s", self.current_epoch,
                         time.perf_counter() - t_epoch,
                         round(val_metrics.get("validation/loss", float("nan")), 5))
            model.on_train_epoch_end(self)
            # counted before the callbacks run, so a checkpoint records the
            # completed epochs and a resume starts the next one
            self.current_epoch += 1
            if not self.fast_dev_run:
                for cb in self.callbacks:
                    cb.on_validation_end(self, self.callback_metrics)
                stop = self.current_epoch >= self.min_epochs and any(
                    cb.stop_training for cb in self.callbacks)
        for cb in self.callbacks:
            cb.on_train_end(self)
        for lg in self.loggers:
            lg.finalize()

    def _log_step(self, metrics: Mapping[str, torch.Tensor]) -> None:
        """A logged step's metrics, to the loggers and the progress log: the
        one place inside an epoch where the loop waits for the device."""
        if not (self.loggers or self.enable_progress_bar):
            return
        host = {k: float(metrics[k]) for k in sorted(metrics)}
        self._log(host, self.global_step)
        if self.enable_progress_bar:
            log.info("epoch %d step %d: %s", self.current_epoch, self.global_step,
                     {k: round(v, 5) for k, v in host.items()})

    def validate(self, model, datamodule, ckpt_path: str | None = None) -> dict[str, float]:
        self._setup(model)
        ckpt_path = self._resolve_ckpt_path(ckpt_path)
        if ckpt_path:
            self._restore(ckpt_path)
        metrics = self._run_eval(model, datamodule, datamodule.val_dataloader(), "validation",
                                 self.limit_val_batches)
        self.callback_metrics.update(metrics)
        self._log(metrics, self.global_step)
        return metrics
