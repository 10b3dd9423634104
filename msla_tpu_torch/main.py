"""Command line of the port (after main.py; reference: src/main.py:214-241).

    python -m msla_tpu_torch train_vqvae=True
    python -m msla_tpu_torch train_transformer=True
    python -m msla_tpu_torch experiment=moe_transformer train_transformer=True
    python -m msla_tpu_torch train_bert=True
    python -m msla_tpu_torch debug=default train_vqvae=True
    python -m msla_tpu_torch -m hparams_search=optuna train_vqvae=True

Composes the repository's configs/train.yaml as it is (``config/``, whose
``instantiate`` maps the JAX package's targets to the port's), trains on the
train_vqvae, train_transformer and train_bert flags (the transformer over
the quantized latents, Audio-BERT over the code ids, of the frozen
``best_vqvae.ckpt``, which must exist), tests, then generates and visualizes
from the checkpoints under ``paths.best_checkpoint_dir``, and returns
``optimized_metric``.

The device comes from ``trainer.accelerator``: "cpu" runs the plain versions
on the CPU, any other value the kernels on the card, which must be present.
Checkpoints are the port's ``torch.save`` files (``train/checkpoint.py``),
Audio-BERT's with a ``frozen-<fingerprint>.ckpt`` sidecar; the JAX package's
msgpack checkpoints are read too.
``generate`` and ``visualize`` skip, with a warning, when a checkpoint they
need is missing, and when a checkpoint does not fit the config (its keys or
shapes); any other error, a kernel's on the card included, raises (ROADMAP.md
§3).

``-m`` (``--multirun``), or a config whose ``hydra.mode`` is MULTIRUN (as
``hparams_search=optuna`` sets it), runs the TPE sweep of ``sweep/`` over
``run``: one composed run a trial, each in its own multirun directory.

Under the launcher (``python -m msla_tpu_torch.parallel.launch --nproc N --
-m msla_tpu_torch ...``) ``main`` joins the process group first
(``parallel.distributed.setup_distributed``, as main.py:304-306 does), every
rank trains its share of each stage, a barrier lets rank 0's checkpoints and
codebook land before the next stage reads them, and generate and visualize
run on rank 0 alone (main.py:272-275). The sweep does not run under the
launcher yet (ROADMAP.md queue item 7.2).
"""
from __future__ import annotations

import random
import sys
from pathlib import Path

import numpy as np
import torch

from msla_tpu_torch.config import (ConfigNode, compose, instantiate, setup_job_logging,
                                   setup_root, setup_run_dir)
from msla_tpu_torch.data.wavio import write_wav
from msla_tpu_torch.data.transform import Quantize
from msla_tpu_torch.parallel.distributed import setup_distributed, teardown_distributed
from msla_tpu_torch.parallel.mesh import group_up, is_main_process, process_info
from msla_tpu_torch.train.checkpoint import files_landed, restore_params
from msla_tpu_torch.utils.instantiators import instantiate_callbacks, instantiate_loggers
from msla_tpu_torch.utils.plotting import (plot_codebook, plot_embeddings_from_quantized,
                                           plot_spectrogram, plot_waveform)
from msla_tpu_torch.utils.pylogger import RankedLogger
from msla_tpu_torch.utils.util import extras, get_metric_value, task_wrapper

CONFIG_DIR = Path(__file__).resolve().parents[1] / "configs"
INSTRUMENTS = ("bass", "drums", "guitar", "piano")

log = RankedLogger(__name__, rank_zero_only=True)


class CheckpointMismatch(RuntimeError):
    """A checkpoint whose keys or shapes do not fit the configured task."""


def seed_everything(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)


def device_of(cfg: ConfigNode) -> str:
    return "cpu" if str(cfg.select("trainer.accelerator", "gpu")) == "cpu" else "cuda"


def make_task(cfg: ConfigNode, name: str):
    """``cfg.model.<name>`` on the run's device, its random init seeded by
    ``cfg.seed``; the transformer's ``latent_channels`` are the VQ-VAE's
    embedding_dim."""
    extra = {}
    if name == "transformer":
        extra["latent_channels"] = int(cfg.model.vqvae.embedding_dim)
    return instantiate(cfg.model[name], device=device_of(cfg), seed=int(cfg.get("seed") or 0),
                       **extra)


def restored_task(cfg: ConfigNode, name: str, ckpt: Path):
    """``make_task`` with the weights of ``ckpt``; CheckpointMismatch when they
    do not fit it."""
    task = make_task(cfg, name)
    state_dict = restore_params(ckpt, task)
    try:
        task.net.load_state_dict(state_dict)
    except RuntimeError as err:  # load_state_dict's missing, unexpected or resized keys
        raise CheckpointMismatch(f"{ckpt} does not fit the config: {err}") from err
    return task


def _make_trainer(cfg: ConfigNode, callbacks, logger, **overrides):
    return instantiate(cfg.trainer, callbacks=callbacks, logger=logger,
                       seed=cfg.get("seed") or 0, **overrides)


@task_wrapper
def train_vqvae(cfg: ConfigNode):
    data_module = instantiate(cfg.data)
    vqvae = make_task(cfg, "vqvae")
    logger = instantiate_loggers(cfg.get("logger"))
    callbacks = instantiate_callbacks(cfg.get("callbacks"))
    trainer = _make_trainer(cfg, callbacks, logger)

    object_dict = {"cfg": cfg, "datamodule": data_module, "model": vqvae,
                   "callbacks": callbacks, "logger": logger, "trainer": trainer}

    if cfg.train:
        trainer.fit(vqvae, data_module, ckpt_path=cfg.get("ckpt_path"))
    train_metrics = dict(trainer.callback_metrics)
    if cfg.test:
        trainer.test(vqvae, data_module, ckpt_path=cfg.get("ckpt_path"))
    test_metrics = dict(trainer.callback_metrics)
    return {**train_metrics, **test_metrics}, object_dict


def _load_vqvae_teacher(cfg: ConfigNode) -> Quantize:
    """The frozen best VQ-VAE of the second stages (reference: src/main.py:62-70)."""
    best_vqvae_file = Path(f"{cfg.paths.best_checkpoint_dir}/best_vqvae.ckpt")
    if not best_vqvae_file.exists():
        raise FileNotFoundError(f"missing {best_vqvae_file}: run train_vqvae=True first")
    return Quantize(restored_task(cfg, "vqvae", best_vqvae_file))


def _train_second_stage(cfg: ConfigNode, name: str, trainer_overrides: dict, **data_kw):
    """``cfg.model.<name>`` trained and tested over the frozen teacher, its
    checkpoints named ``best_<name>`` (main.py:80-156)."""
    quantizer = _load_vqvae_teacher(cfg)
    data_module = instantiate(cfg.data, quantizer=quantizer, **data_kw)
    task = make_task(cfg, name)
    logger = instantiate_loggers(cfg.get("logger"))

    callbacks = None
    if cfg.get("callbacks") is not None:
        callbacks = [instantiate(cfg.callbacks.model_checkpoint, filename=f"best_{name}"),
                     instantiate(cfg.callbacks.early_stopping)]
    trainer = _make_trainer(cfg, callbacks, logger, **trainer_overrides)

    object_dict = {"cfg": cfg, "datamodule": data_module, "model": task,
                   "callbacks": callbacks, "logger": logger, "trainer": trainer}
    if cfg.train:
        trainer.fit(task, data_module, ckpt_path=cfg.get("ckpt_path"))
    train_metrics = dict(trainer.callback_metrics)
    if cfg.test:
        trainer.test(task, data_module, ckpt_path=cfg.get("ckpt_path"))
    test_metrics = dict(trainer.callback_metrics)
    return {**train_metrics, **test_metrics}, object_dict


@task_wrapper
def train_transformer(cfg: ConfigNode):
    """The transformer over the teacher's quantized latents."""
    return _train_second_stage(cfg, "transformer", {}, quantized_latents=True)


@task_wrapper
def train_bert(cfg: ConfigNode):
    """Audio-BERT over the teacher's code ids; the trainer's epochs as
    main.py:139-143 sets them."""
    return _train_second_stage(cfg, "bert", dict(max_epochs=3, min_epochs=1))


def _first_predict_batch(cfg: ConfigNode) -> np.ndarray:
    data_module = instantiate(cfg.data, batch_size=1, masking=False)
    return np.asarray(next(iter(data_module.predict_dataloader())))  # (1, 4, T)


def visualize(cfg: ConfigNode) -> None:
    """Plot suite on one predict sample (reference: src/main.py:166-181)."""
    codebook_file = Path(str(cfg.paths.codebook_file))
    best_vqvae = Path(f"{cfg.paths.best_checkpoint_dir}/best_vqvae.ckpt")
    if not codebook_file.exists() or not best_vqvae.exists():
        log.warning("visualize: skipping (codebook.csv or best_vqvae.ckpt missing)")
        return

    task = restored_task(cfg, "vqvae", best_vqvae)
    instruments = _first_predict_batch(cfg)
    mixed = instruments.squeeze(0).sum(axis=0).reshape(1, 1, -1)

    plot_embeddings_from_quantized(cfg, (mixed, instruments), task)
    plot_codebook(cfg)

    plot_dir = str(cfg.paths.plot_dir)
    sr = int(cfg.data.target_sample_rate)
    for idx, name in enumerate(INSTRUMENTS):
        plot_spectrogram(instruments[:, idx, :], plot_dir=plot_dir, sample_rate=sr, title=name)
        plot_waveform(instruments[:, idx, :], plot_dir=plot_dir, sample_rate=sr, title=name)
    plot_spectrogram(mixed.squeeze(0), plot_dir=plot_dir, sample_rate=sr, title="song")
    plot_waveform(mixed.squeeze(0), plot_dir=plot_dir, sample_rate=sr, title="song")

    svgs = sorted(Path(plot_dir).glob("*.svg"))
    log.info(f"visualize: wrote {len(svgs)} SVGs to {plot_dir}: "
             + ", ".join(f"{p.name} ({p.stat().st_size} B)" for p in svgs))


def corrupt(instruments: np.ndarray) -> tuple[np.ndarray, int]:
    """One random stem of (1, 4, T) stems replaced by uniform noise, drawn as
    main.py draws it: ``random.randint(0, 3)``, then ``np.random.random``."""
    idx = random.randint(0, 3)
    instruments = instruments.copy()
    instruments[:, idx, :] = np.random.random(instruments.shape[-1]).astype(np.float32)
    return instruments, idx


@torch.no_grad()
def generate(cfg: ConfigNode) -> None:
    """Audio-BERT generation (reference: src/main.py:184-211): corrupt one
    random stem with noise, quantize through the VQ-VAE, reconstruct through
    Audio-BERT, save both WAVs."""
    best_dir = Path(str(cfg.paths.best_checkpoint_dir))
    if not (best_dir / "best_bert.ckpt").exists() or not (best_dir / "best_vqvae.ckpt").exists():
        log.warning("generate: skipping (best_bert.ckpt or best_vqvae.ckpt missing)")
        return

    instruments = _first_predict_batch(cfg)
    bert = restored_task(cfg, "bert", best_dir / "best_bert.ckpt")
    vqvae = restored_task(cfg, "vqvae", best_dir / "best_vqvae.ckpt")
    instruments, idx = corrupt(instruments)

    stems = torch.from_numpy(instruments).to(vqvae.device)
    q = vqvae.get_quantized(stems)
    output = bert.predict_step((q.encoding_indices, stems)).cpu().numpy()

    ckpt_dir = Path(str(cfg.paths.checkpoint_dir))
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    sr = int(cfg.data.target_sample_rate)
    write_wav(ckpt_dir / "random_instrument.wav", instruments[:, idx, :], sr)
    write_wav(ckpt_dir / "bert_generated_during_evaluation.wav", output[:, idx, :], sr)
    for name in ("random_instrument.wav", "bert_generated_during_evaluation.wav"):
        p = ckpt_dir / name
        log.info(f"generate: wrote {p} ({p.stat().st_size} bytes)")


def run(cfg: ConfigNode) -> float | None:
    """One composed-config run (the body of @hydra.main; reference: main.py:215-236)."""
    extras(cfg)
    if cfg.get("seed") is not None:
        seed_everything(int(cfg.seed))

    metric_dict: dict = {}
    if cfg.train_vqvae:
        metric_dict, _ = train_vqvae(cfg)
    for flag, stage in (("train_transformer", train_transformer), ("train_bert", train_bert)):
        if cfg[flag]:
            files_landed()  # the teacher rank 0 wrote, before any rank reads it
            metric_dict, _ = stage(cfg)

    if not is_main_process():  # single-device analyses that write fixed paths
        return get_metric_value(metric_dict=metric_dict,
                                metric_name=cfg.get("optimized_metric"))
    for enabled, step in ((cfg.get("generate", True), generate),
                          (cfg.get("visualize", True), visualize)):
        if not enabled:
            continue
        try:
            step(cfg)
        except CheckpointMismatch as err:
            log.warning(f"{step.__name__} failed ({err}) — retrain or point paths at the "
                        "matching artifacts — skipping")
    return get_metric_value(metric_dict=metric_dict, metric_name=cfg.get("optimized_metric"))


def main(argv: list[str] | None = None) -> float | None:
    """The command line; a rank of a launched run joins its process group
    first, and leaves it when ``main`` returns."""
    joined = setup_distributed()  # no-op on one process
    result = _main(argv)
    if joined:  # a rank that fails leaves without a barrier: the launcher stops the rest
        files_landed()
        teardown_distributed()
    return result


def _main(argv: list[str] | None) -> float | None:
    argv = list(sys.argv[1:] if argv is None else argv)
    multirun = False
    for flag in ("-m", "--multirun"):
        if flag in argv:
            multirun = True
            argv.remove(flag)
    setup_root(__file__, indicator=".project-root")
    cfg = compose(CONFIG_DIR, "train", argv)
    if multirun or str(cfg.select("hydra.mode", "")) == "MULTIRUN":
        if process_info()[1] > 1:
            raise NotImplementedError("the sweep under the launcher is not ported yet: "
                                      "ROADMAP.md queue item 7.2")
        from msla_tpu_torch.sweep.sweeper import run_sweep

        return run_sweep(CONFIG_DIR, "train", argv, run)
    setup_run_dir(cfg)
    setup_job_logging(cfg, str(cfg.task_name))
    if group_up():
        rank, world = process_info()
        log.info(f"Data parallel: rank {rank} of {world}, {torch.distributed.get_backend()}")
    return run(cfg)
