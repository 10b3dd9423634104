"""Training loop (port of msla_tpu/train/trainer.py: fit, validate, test and predict).

The constructor takes the JAX Trainer's keywords. What the port runs:
``fit``, ``validate``, ``test`` and ``predict`` (each with ``ckpt_path``),
``save_checkpoint``; ``max_epochs``, ``min_epochs``, ``limit_train_batches``,
``limit_val_batches``, ``limit_test_batches``, ``fast_dev_run``,
``detect_anomaly``, ``profiler`` ("simple", "jax"), ``log_every_n_steps``,
``enable_progress_bar``, ``default_root_dir``, ``callbacks``, ``logger``,
``accumulate_grad_batches``, ``remat``, ``precision``, ``seed``, and
``devices`` and ``num_nodes`` as data parallelism over ``torch.distributed``
(below); epoch metrics as batch-size-weighted means of the per-batch means
(Lightning's ``on_epoch`` reduction), in ``callback_metrics``. The model
axis's keywords (``model_parallel``, ``pipeline_*``, ``zero1``, ``fsdp``)
wait for ROADMAP.md queue item 7 and raise ``NotImplementedError`` naming it
when given anything but their default.

One train step, in the order of the JAX step (msla_tpu/train/trainer.py:
354-406): ``datamodule.train_transform`` (the masking augment) →
``datamodule.on_after_batch_transfer`` (the mixture broadcast, or the frozen
VQ-VAE teacher's code ids under ``torch.no_grad()`` for Audio-BERT) →
``model.loss_fn`` → backward → the optimizer's step. On the card nothing in
the loop waits for the device: batches are copied one step ahead from pinned
memory on a side stream, and metrics stay device tensors until the epoch ends
(or until a logged step, ``log_every_n_steps``, reads them).

``accumulate_grad_batches=k`` groups k loader batches into one optimizer
step on the mean of their gradients (msla_tpu/train/trainer.py:132-137,
270-307, 372-395): each microbatch's backward adds its gradient, in turn,
and the sum is divided by k, the same math as a k× batch for the
mean-reduced losses of every task. A batch of another shape (a ragged last
one) or a short tail flushes as a smaller group; ``global_step`` counts
optimizer steps; a step's metrics are the mean over its microbatches, and an
epoch's are weighted by the group's examples. The microbatches draw from the
step generator in turn (JAX folds each one's index into the step key).

``remat=True`` runs the whole loss under ``torch.utils.checkpoint``
(non-reentrant), as ``jax.checkpoint`` wraps the JAX step's loss: the
backward recomputes the forward instead of keeping its activations. The
recomputation draws from the step generator's state as the forward found
it, and leaves the generator where the forward left it, so the masks of
dropout and BERT's [MASK] are the forward's and the gradients equal
``remat=False``'s bit for bit. The kernels of the forward launch twice a
step (K1b and K2b: their saved hidden is recomputed too).

Around the epochs, as the JAX Trainer (msla_tpu/train/trainer.py:448-577):
the loggers get the task's hparams once per ``fit``, each logged step's
metrics and, after each validation, the epoch's; then ``current_epoch``
counts the epoch and the callbacks' ``on_validation_end`` runs (checkpoint
callbacks last, so that ``last.ckpt`` holds the others' state: ROADMAP.md §3);
training stops once a callback asks and ``min_epochs`` are done.
``ckpt_path`` is a path, "last" or "best" (resolved through the
ModelCheckpoint callback) and restores the weights, Adam's state, the epoch,
the global step, the per-step generator and the callbacks' state (by class
name, the n-th callback of a class taking the n-th saved state of that
class). A JAX package's msgpack checkpoint gives every entry its weights (the
task's ``state_dict_from_jax``) and ``fit`` its optimizer state too (the
task's ``optimizer_state_from_jax``: optax's moments and count as torch's);
it holds no generator, so the step generator starts from ``seed`` + 1, as a
new ``fit``'s (ROADMAP.md §3). Checkpoints keep the
task's ``frozen_param_keys`` in a sidecar (``train/checkpoint.py``);
``save_checkpoint(..., background=True)`` (ModelCheckpoint's) copies the
state and leaves the write to the writer thread, and ``fit``, ``test``,
``validate`` and ``predict`` return once every write has landed. The
task's ``on_validation_batch_end`` runs after each validation batch (the
audio demo of the first one), with the datamodule as ``trainer.datamodule``.

``predict`` runs ``predict_step`` over the predict loader and returns the
outputs a batch each; a ragged last batch is padded to the first batch's rows
by repeating its first row (a batch-global reduction, as Audio-BERT's rescale
over the batch's largest id, then sees no new value) and the pad rows are
dropped from its output.

``detect_anomaly=True`` runs ``fit``'s steps under
``torch.autograd.set_detect_anomaly``, Lightning's meaning: a backward that
makes a NaN raises (the JAX Trainer sets ``jax_debug_nans``).
``profiler="simple"`` (or "advanced", as in JAX) times the train steps, the
evaluation steps and each validation on the host clock and logs the summary
when ``fit`` ends; on the card a step's time is the time to enqueue it.
``profiler="jax"`` writes a ``torch.profiler`` trace of ``fit`` (CPU and, on
the card, CUDA activities) into ``default_root_dir/jax_trace``, the
directory of the JAX Trainer's XLA trace, as ``<host>_<pid>.<ns>.pt.trace.json``
(Chrome trace format, ROADMAP.md §3); any other string turns profiling off,
as in JAX.

``accelerator="cpu"`` trains on the CPU; any other value on the card, which
must be present. The task must already live on that device. ``seed`` seeds
the generator of the per-step random draws (the augment's masks); the
weights' init is seeded where the task is built.

Data parallelism (after msla_tpu/train/trainer.py:188-193, 247, 614-688 under
``jax.distributed``): started by ``python -m msla_tpu_torch.parallel.launch``
and joined by ``parallel.distributed.setup_distributed``, each rank drives one
device (``cuda:LOCAL_RANK``, or the CPU under gloo) and its loaders read its
interleave of the data. ``devices`` counts the ranks of a node and
``devices`` × ``num_nodes`` must be the world size (-1: any); otherwise
``ValueError`` names the launcher. An N-rank run computes what one process
computes on the global batch, the ranks' batches side by side:

* each step runs inside ``parallel.mesh.data_axis()``, where the tasks'
  reductions over the batch are global (the VQ's code counts, Audio-BERT's
  largest id, the MoE's load-balance means); after the backward (the last
  microbatch's, the recomputed one under ``remat``) the gradient is
  all-reduced as one flat buffer and divided by the world size, so every rank
  takes the same optimizer step (no ``DistributedDataParallel`` wrapper,
  whose ``module.`` prefix would rename every key of a checkpoint);
* metrics stay on each rank until a logged step or the epoch's end, where
  the batch-weighted sums and the row counts are all-reduced: every rank
  holds the same ``callback_metrics``, so the callbacks decide alike;
* the augment's masks are drawn for the global batch from the step generator,
  which every rank holds in the same state, each rank taking its rows'; the
  task's own draws (dropout, Audio-BERT's [MASK]) come from a stream of each
  rank's own, reseeded every step from (``seed``, rank, step) (ROADMAP.md §3);
* rank 0 alone writes checkpoints, logs, the profiler's trace and summary;
  a checkpoint that rank 0 wrote is read by the others after its write has
  landed and a barrier;
* ``predict`` gathers every rank's outputs and returns them in loader order
  on every rank.
"""
from __future__ import annotations

import logging
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path
from typing import Iterable, Iterator, Mapping

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from msla_tpu_torch.ops.conv_adjoints import fp32_convs
from msla_tpu_torch.parallel.mesh import (all_sum, data_axis, gather_rows, group_up,
                                          is_main_process, mean_gradients, process_info,
                                          resolve_devices)
from msla_tpu_torch.train.callbacks import ModelCheckpoint
from msla_tpu_torch.train.checkpoint import (files_landed, load_checkpoint, save_checkpoint,
                                             wait_for_pending, weights_of)

log = logging.getLogger(__name__)

_PARALLEL = "ROADMAP.md queue item 7 (the opt-ins: parallel/, the model axis)"


def _refuse(name: str, value, default, item: str) -> None:
    if value != default:
        raise NotImplementedError(f"Trainer {name}={value!r} is not ported yet: {item}")


@contextmanager
def _joined_writes():
    """Join every background checkpoint write on the way out: a failed write
    raises, unless another error is already on its way, which it would
    mask (that write's error is then logged)."""
    try:
        yield
    except BaseException:
        try:
            wait_for_pending()
        except Exception:
            log.exception("background checkpoint write failed")
        raise
    wait_for_pending()


class _SimpleProfiler:
    """Wall-clock section profiler (after msla_tpu/train/trainer.py:47-73;
    the reference's debug config: profiler: simple)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextmanager
    def track(self, name: str):
        t0 = time.perf_counter()
        yield
        if self.enabled:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = ["Profiler report (wall-clock):"]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"  {name:<24s} total {total:8.3f}s  calls {n:5d}  mean {total / n:8.4f}s")
        return "\n".join(lines)


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
        and unknown strings as "medium"). ``devices``: the ranks of a node,
        one device each (-1: any number); with ``num_nodes``, checked against
        the process group (``parallel.mesh.resolve_devices``).
        ``default_root_dir`` holds only the ``profiler="jax"`` trace, as in
        the JAX Trainer. ``pipeline_microbatches`` waits with the feature
        that reads it."""
        for name, value, default in (("model_parallel", model_parallel, 1),
                                     ("pipeline_parallel", pipeline_parallel, 1),
                                     ("pipeline_microbatches", pipeline_microbatches, 2),
                                     ("zero1", zero1, False), ("fsdp", fsdp, False)):
            _refuse(name, value, default, _PARALLEL)

        self.default_root_dir = Path(default_root_dir)
        self.min_epochs = int(min_epochs or 0)
        self.max_epochs = int(max_epochs)
        self.enable_progress_bar = enable_progress_bar
        self.log_every_n_steps = log_every_n_steps or 0
        self.fast_dev_run = fast_dev_run
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.limit_test_batches = limit_test_batches
        self.detect_anomaly = bool(detect_anomaly)
        self.profiler = _SimpleProfiler(profiler in ("simple", "advanced"))
        self._trace = profiler == "jax"
        self.accumulate_grad_batches = max(1, int(accumulate_grad_batches))
        self.remat = bool(remat)
        self.seed = seed
        # checkpoint callbacks run last, so last.ckpt holds the others' state
        self.callbacks = sorted(callbacks or [], key=lambda cb: isinstance(cb, ModelCheckpoint))
        self.loggers = list(logger) if isinstance(logger, (list, tuple)) else \
            ([logger] if logger else [])
        self.device = resolve_devices(accelerator, devices, num_nodes)
        self.rank, self.world_size = process_info()
        self.is_main = is_main_process()

        self.callback_metrics: dict[str, float] = {}
        self.current_epoch = 0
        self.global_step = 0
        self._model = None
        self.datamodule = None
        self._optimizer: torch.optim.Optimizer | None = None
        self._generator: torch.Generator | None = None
        self._rank_generator: torch.Generator | None = None
        self._copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    # ---- checkpoint plumbing ---------------------------------------------------------
    def save_checkpoint(self, path, weights_only: bool = False, background: bool = False,
                        wire: str | None = None):
        """One .ckpt file (``train/checkpoint.py``) of the task's weights,
        the optimizer's state (unless ``weights_only``, Lightning's
        ``save_weights_only``), the epoch, the global step, the per-step
        generator and the callbacks' state; the task's
        ``frozen_param_keys`` go to the directory's sidecar. With
        ``background`` the state is copied now and written by the writer
        thread, and the write's future is returned. ``wire`` encodes it on
        the device first (``train/checkpoint.py``'s codecs). Rank 0 alone
        writes: every rank holds the same state, so nothing is gathered, and
        the others return None."""
        if self._model is None:
            raise RuntimeError("save_checkpoint needs a task: call fit or validate first")
        if not self.is_main:
            return None
        return save_checkpoint(path,
                        state_dict=self._model.net.state_dict(),
                        opt_state=None if weights_only else self._optimizer.state_dict(),
                        epoch=self.current_epoch, global_step=self.global_step,
                        hparams=getattr(self._model, "hparams", {}),
                        callback_metrics=self.callback_metrics,
                        callbacks_state=[{"class": type(cb).__name__, "state": cb.state_dict()}
                                         for cb in self.callbacks],
                        generator_state=self._generator.get_state(),
                        frozen_keys=tuple(self._model.frozen_param_keys),
                        background=background, wire=wire)

    def _resolve_ckpt_path(self, ckpt_path):
        """Lightning's meaning: "best" and "last" resolve through the
        ModelCheckpoint callback; None keeps the current weights. Every file
        rank 0 has in flight lands before any rank reads one."""
        if ckpt_path and self.world_size > 1:
            files_landed()
        if ckpt_path not in ("best", "last"):
            return ckpt_path
        for cb in self.callbacks:
            if isinstance(cb, ModelCheckpoint):
                if ckpt_path == "best" and cb.best_model_path:
                    return cb.best_model_path
                last = cb.dirpath / "last.ckpt"
                wait_for_pending(last)  # a background write in flight
                if ckpt_path == "last" and last.exists():
                    return str(last)
        raise RuntimeError(f"ckpt_path='{ckpt_path}' requested but no ModelCheckpoint "
                           "callback has a saved checkpoint")

    def _restore(self, ckpt_path) -> None:
        payload = load_checkpoint(ckpt_path)
        jax_file = payload.get("format") == "jax"
        self._model.net.load_state_dict(weights_of(self._model, payload))
        if payload.get("opt_state"):
            self._optimizer.load_state_dict(
                self._model.optimizer_state_from_jax(self._optimizer, payload["opt_state"])
                if jax_file else payload["opt_state"])
        if "generator" in payload:
            self._generator.set_state(payload["generator"])
        elif jax_file:  # JAX folds its draws from the step count: no state to carry
            self._generator.manual_seed(self.seed + 1)
        self.current_epoch = int(payload.get("epoch", 0))
        self.global_step = int(payload.get("global_step", 0))
        # by class name, in order of occurrence: the JAX Trainer keeps the
        # config's order and the port sorts ModelCheckpoint last
        saved: dict[str, list] = defaultdict(list)
        for entry in payload.get("callbacks") or []:
            saved[entry.get("class")].append(entry.get("state", {}))
        for cb in self.callbacks:
            states = saved[type(cb).__name__]
            if states:
                cb.load_state_dict(states.pop(0))
        log.info("Restored checkpoint %s (epoch %d, step %d)", ckpt_path, self.current_epoch,
                 self.global_step)

    @property
    def _writing_loggers(self) -> list:
        """The loggers, on rank 0; none on the others."""
        return self.loggers if self.is_main else []

    def _log(self, metrics: Mapping[str, float], step: int) -> None:
        for lg in self._writing_loggers:
            lg.log_metrics(metrics, step)

    # ---- loop helpers --------------------------------------------------------------
    @staticmethod
    def _limit(n_batches: int, fraction_or_count) -> int:
        if fraction_or_count is None:
            return n_batches
        if isinstance(fraction_or_count, float) and fraction_or_count <= 1.0:
            return max(1, int(n_batches * fraction_or_count))
        return min(n_batches, int(fraction_or_count))

    def _setup(self, model, datamodule) -> None:
        self.datamodule = datamodule
        if model.device != self.device:
            raise ValueError(f"the task lives on {model.device} and the Trainer runs on "
                             f"{self.device}: build the task with device={str(self.device)!r}")
        if self._model is not model:
            self._model = model
            self._optimizer = model.configure_optimizer()
            self._generator = torch.Generator(device=self.device).manual_seed(self.seed + 1)
            if self.world_size > 1:
                self._rank_generator = torch.Generator(device=self.device)

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

    def _groups(self, loader: Iterable, max_batches: int) -> Iterator[tuple[int, list]]:
        """(examples, device batches) of each optimizer step: k loader
        batches, fewer where a batch of another shape or the epoch's end
        flushes the group (msla_tpu/train/trainer.py:270-307)."""
        k = self.accumulate_grad_batches
        group: list[torch.Tensor] = []
        for _, batch in self._prefetched(loader, max_batches):
            if group and batch.shape != group[0].shape:
                yield sum(len(b) for b in group), group
                group = []
            group.append(batch)
            if len(group) == k:
                yield sum(len(b) for b in group), group
                group = []
        if group:
            yield sum(len(b) for b in group), group

    def _task_generator(self) -> torch.Generator:
        """The generator of the task's own draws this step: the step
        generator on one rank; on N, the rank's stream, reseeded from (seed,
        rank, step) so that ranks draw apart and a resume draws alike."""
        if self._rank_generator is None:
            return self._generator
        seed = ((self.seed + 1) * 1_000_003 + self.rank) * 1_000_003 + self.global_step
        return self._rank_generator.manual_seed(seed % (1 << 63))

    def _loss(self, model, batch, generator: torch.Generator):
        """``model.loss_fn`` on ``generator``; under ``remat`` inside
        ``torch.utils.checkpoint``, whose recomputation replays the
        generator: torch's ``preserve_rng_state`` restores only the global
        generators."""
        if not self.remat:
            return model.loss_fn(batch, generator)
        start = generator.get_state()
        forward_done = []

        def loss_fn():
            if not forward_done:
                forward_done.append(True)
                return model.loss_fn(batch, generator)
            after = generator.get_state()
            generator.set_state(start)
            try:  # the recomputation may stop early, by an exception
                return model.loss_fn(batch, generator)
            finally:
                generator.set_state(after)

        return checkpoint(loss_fn, use_reentrant=False)

    def _train_step(self, model, datamodule, group: list[torch.Tensor]
                    ) -> dict[str, torch.Tensor]:
        """One optimizer step on the mean gradient of ``group``'s batches
        (and, in a data-parallel run, of the ranks')."""
        transform = getattr(datamodule, "train_transform", None)
        self._optimizer.zero_grad(set_to_none=True)
        generator = self._task_generator()
        sums: dict[str, torch.Tensor] = {}
        with data_axis():
            for raw in group:
                if transform is not None:
                    raw = transform(raw, self._generator)
                loss, metrics = self._loss(model, datamodule.on_after_batch_transfer(raw),
                                           generator)
                with fp32_convs():  # the convs' adjoints run here, outside the forward's scope
                    loss.backward()
                for k, v in metrics.items():
                    sums[k] = sums[k] + v.detach() if k in sums else v.detach()
        if len(group) > 1:
            for p in model.net.parameters():
                if p.grad is not None:
                    p.grad /= len(group)
            sums = {k: v / len(group) for k, v in sums.items()}
        mean_gradients(model.net.parameters())
        self._optimizer.step()
        return sums

    @staticmethod
    def _accumulate(sums: dict, metrics: Mapping[str, torch.Tensor], rows: int) -> None:
        for k, v in metrics.items():  # device tensors: no wait for the device here
            sums[k] = sums[k] + v * rows if k in sums else v * rows

    def _means(self, sums: dict, rows: int) -> dict[str, float]:
        """Epoch means as host floats, in one transfer, in sorted key order as
        the JAX Trainer's jitted steps return them (so logged columns match);
        in a data-parallel run the sums and rows of every rank."""
        if not sums:
            return {}
        keys = sorted(sums)
        values = torch.stack([sums[k].float() for k in keys])
        if group_up():
            with data_axis():
                total = all_sum(torch.cat([values, values.new_full((1,), rows)]))
            values, rows = total[:-1], total[-1].item()
        return {k: v / max(rows, 1) for k, v in zip(keys, values.tolist())}

    @torch.no_grad()
    def _run_eval(self, model, datamodule, loader, mode: str, limit) -> dict[str, float]:
        sums: dict = {}
        rows = 0
        max_batches = self._limit(len(loader), 1 if self.fast_dev_run else limit)
        for batch_idx, (n, raw) in enumerate(self._prefetched(loader, max_batches)):
            with self.profiler.track(f"{mode}_step"), data_axis():
                metrics = model.eval_metrics(datamodule.on_after_batch_transfer(raw), mode)
            self._accumulate(sums, metrics, n)
            rows += n
            if mode == "validation":
                model.on_validation_batch_end(self, raw, batch_idx)
        return self._means(sums, rows)

    # ---- public API --------------------------------------------------------------
    def fit(self, model, datamodule, ckpt_path: str | None = None) -> None:
        """Returns once every background checkpoint write has landed; a
        failed write fails ``fit``."""
        with _joined_writes():
            try:
                with torch.autograd.set_detect_anomaly(self.detect_anomaly), self._traced():
                    self._fit(model, datamodule, ckpt_path)
            finally:
                if self.profiler.enabled and self.profiler.totals and self.is_main:
                    log.info("%s", self.profiler.summary())

    @contextmanager
    def _traced(self):
        """``profiler="jax"``: a torch.profiler trace of what runs inside,
        written to ``default_root_dir/jax_trace`` when it ends; rank 0's."""
        if not (self._trace and self.is_main):
            yield
            return
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        trace_dir = self.default_root_dir / "jax_trace"
        log.info("Writing the torch profiler trace to %s", trace_dir)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(
                str(trace_dir))):
            yield

    def _fit(self, model, datamodule, ckpt_path) -> None:
        train_loader = datamodule.train_dataloader()
        val_loader = datamodule.val_dataloader()
        if len(train_loader) == 0:
            raise RuntimeError("empty train dataloader — check data_dir and batch_size")
        self._setup(model, datamodule)
        ckpt_path = self._resolve_ckpt_path(ckpt_path)
        if ckpt_path:
            self._restore(ckpt_path)
        for lg in self._writing_loggers:
            lg.log_hyperparams(getattr(model, "hparams", {}))

        max_epochs = 1 if self.fast_dev_run else self.max_epochs
        stop = False
        while self.current_epoch < max_epochs and not stop:
            sums: dict = {}
            rows = 0
            max_batches = self._limit(len(train_loader),
                                      1 if self.fast_dev_run else self.limit_train_batches)
            t_epoch = time.perf_counter()
            for n, group in self._groups(train_loader, max_batches):
                with self.profiler.track("train_step"):
                    metrics = self._train_step(model, datamodule, group)
                self.global_step += 1
                rows += n
                self._accumulate(sums, metrics, n)
                if self.log_every_n_steps and self.global_step % self.log_every_n_steps == 0:
                    self._log_step(metrics, n)
            train_epoch = self._means(sums, rows)
            self.callback_metrics.update(train_epoch)

            with self.profiler.track("validation"):
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
        for lg in self._writing_loggers:
            lg.finalize()

    def _log_step(self, metrics: Mapping[str, torch.Tensor], rows: int) -> None:
        """A logged step's metrics (of the global batch: the ranks' means
        weighted by their ``rows``), to the loggers and the progress log: the
        one place inside an epoch where the loop waits for the device."""
        if not (self.loggers or self.enable_progress_bar):
            return
        if self.world_size > 1:
            host = self._means({k: v * rows for k, v in metrics.items()}, rows)
        else:
            host = {k: float(metrics[k]) for k in sorted(metrics)}
        self._log(host, self.global_step)
        if self.enable_progress_bar:
            log.info("epoch %d step %d: %s", self.current_epoch, self.global_step,
                     {k: round(v, 5) for k, v in host.items()})

    def validate(self, model, datamodule, ckpt_path: str | None = None) -> dict[str, float]:
        return self._eval_entry(model, datamodule, "validation", datamodule.val_dataloader(),
                                self.limit_val_batches, ckpt_path)

    def test(self, model, datamodule, ckpt_path: str | None = None) -> dict[str, float]:
        """The test split's metrics (after msla_tpu/train/trainer.py:555-579)."""
        return self._eval_entry(model, datamodule, getattr(model, "test_mode_name", "test"),
                                datamodule.test_dataloader(), self.limit_test_batches,
                                ckpt_path)

    def _eval_entry(self, model, datamodule, mode: str, loader, limit,
                    ckpt_path) -> dict[str, float]:
        with _joined_writes():
            return self._evaluate(model, datamodule, mode, loader, limit, ckpt_path)

    def _evaluate(self, model, datamodule, mode: str, loader, limit,
                  ckpt_path) -> dict[str, float]:
        self._setup(model, datamodule)
        ckpt_path = self._resolve_ckpt_path(ckpt_path)
        if ckpt_path:
            self._restore(ckpt_path)
        metrics = self._run_eval(model, datamodule, loader, mode, limit)
        self.callback_metrics.update(metrics)
        self._log(metrics, self.global_step)
        return metrics

    def predict(self, model, datamodule, ckpt_path: str | None = None) -> list[torch.Tensor]:
        """``model.predict_step`` on each batch of the predict loader, on the
        device (after msla_tpu/train/trainer.py:592-690). In a data-parallel
        run every rank returns every rank's rows, in loader order: rank r's
        j-th row of a batch is loader position j·N + r, the wrap-padded
        duplicates of the loader's last rows included, as JAX returns them."""
        with _joined_writes():
            return self._predict(model, datamodule, ckpt_path)

    @torch.no_grad()
    def _predict(self, model, datamodule, ckpt_path) -> list[torch.Tensor]:
        self._setup(model, datamodule)
        ckpt_path = self._resolve_ckpt_path(ckpt_path)
        if ckpt_path:
            self._restore(ckpt_path)
        loader = datamodule.predict_dataloader()
        rows: list[int] = []
        outputs = []
        world = self.world_size
        for i, (bucket, batch) in enumerate(self._prefetched(self._padded(loader, rows),
                                                             len(loader))):
            with data_axis():
                out = model.predict_step(datamodule.on_after_batch_transfer(batch))
            if world == 1:
                outputs.append(out[:rows[i]])
                continue
            order = torch.tensor([p * bucket + j for j in range(rows[i]) for p in range(world)],
                                 device=self.device)
            outputs.append(gather_rows(out).index_select(0, order))
        return outputs

    @staticmethod
    def _padded(loader: Iterable, rows: list[int]) -> Iterator[np.ndarray]:
        """The loader's batches, a short one padded on the host, before its one
        copy to the device, to the first batch's rows by repeating its first
        row; each batch's real rows appended to ``rows``."""
        bucket = None
        for raw in loader:
            arr = np.asarray(raw, dtype=np.float32)
            rows.append(arr.shape[0])
            bucket = arr.shape[0] if bucket is None else bucket
            if arr.shape[0] < bucket:
                pad = np.broadcast_to(arr[:1], (bucket - arr.shape[0],) + arr.shape[1:])
                arr = np.concatenate([arr, pad])
            yield arr
