"""The port's config loader (msla_tpu_torch/config/) against the JAX
package's on the repository's configs/, read as they are.

Every option of every config group composes to the JAX package's tree, raw
(interpolations unresolved) and resolved under one run directory; the
interpolations, ``@package _global_``, CLI overrides, additions and deletions,
and the run directory behave alike. ``instantiate`` maps each ``msla_tpu.``
target to ``msla_tpu_torch.`` and builds the port's objects (every target of
configs/, the sweep's included, has a counterpart), and a target that would
import JAX or the JAX package raises. The loggers of configs/logger/ and
``experiment=vqvae_slakh`` instantiate on the port.
"""
from datetime import datetime
from pathlib import Path

import pytest

from msla_tpu import config as jax_config
from msla_tpu_torch import config
from msla_tpu_torch.config.instantiate import retarget

CONFIG_DIR = Path(__file__).resolve().parents[1] / "configs"
OPTIONS = [f"{group.name}={option.stem}" for group in sorted(CONFIG_DIR.iterdir())
           if group.is_dir() for option in sorted(group.glob("*.yaml"))]
NOW = datetime(2026, 1, 2, 3, 4, 5)


def _both(overrides):
    return (config.compose(CONFIG_DIR, "train", overrides),
            jax_config.compose(CONFIG_DIR, "train", overrides))


def _resolved(cfg, node_cls):
    """The tree resolved at one fixed ``${now:...}``."""
    return node_cls(cfg.to_container(resolve=False), _now=NOW).to_container(resolve=True)


@pytest.mark.parametrize("override", OPTIONS)
def test_every_config_group_option_composes_to_the_jax_tree(override, tmp_path, monkeypatch):
    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path))
    got, want = _both([override])
    assert got.to_container(resolve=False) == want.to_container(resolve=False)
    assert _resolved(got, config.ConfigNode) == _resolved(want, jax_config.ConfigNode)


def test_the_group_options_are_all_there():
    assert len(OPTIONS) >= 20 and "debug=default" in OPTIONS and "logger=csv" in OPTIONS


@pytest.mark.parametrize("overrides", [
    [],
    ["debug=default", "train_vqvae=True", "data.target_sample_rate=4000", "data.batch_size=2"],
    ["data.batch_size=8", "train_vqvae=True", "model.vqvae.learning_rate=0.01", "tags=[a,b]",
     "+extra_key=hello", "ckpt_path=/tmp/x.ckpt", "~callbacks.early_stopping"],
    ["experiment=large_batch", "logger=tensorboard", "trainer.max_epochs=3"],
    ["hparams_search=optuna"],
    ["debug=default", "callbacks=default", "+model.vqvae.compute_dtype=bfloat16"],
])
def test_overrides_compose_alike(overrides, tmp_path, monkeypatch):
    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path))
    got, want = _both(overrides)
    assert got.to_container(resolve=False) == want.to_container(resolve=False)
    assert _resolved(got, config.ConfigNode) == _resolved(want, jax_config.ConfigNode)


def test_interpolation_and_global_package(tmp_path, monkeypatch):
    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path))
    monkeypatch.setenv("SLAKH_DIR", str(tmp_path / "slakh"))
    cfg = config.compose(CONFIG_DIR, "train", ["debug=default", "data.target_sample_rate=4000"])
    assert cfg.task_name == "debug" and cfg.get("callbacks") is None
    assert cfg.trainer.accelerator == "cpu" and cfg.trainer.detect_anomaly is True
    assert cfg.trainer.profiler == "simple" and cfg.trainer.limit_test_batches == 0.1
    assert cfg.model.vqvae.sample_rate == 4000  # ${data.target_sample_rate}
    assert cfg.paths.train_dir == str(tmp_path / "slakh" / "train")
    assert cfg.paths.codebook_file == str(tmp_path / "logs" / "best_checkpoint" / "codebook.csv")
    with pytest.raises(config.ComposeError):
        config.compose(CONFIG_DIR, "train", ["debug=nonexistent"])


def test_run_dir_as_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path))
    got, want = _both(["debug=default"])
    for cfg, node_cls in ((got, config.ConfigNode), (want, jax_config.ConfigNode)):
        object.__setattr__(cfg, "_now", NOW)
    run_dir = config.setup_run_dir(got)
    assert run_dir == jax_config.setup_run_dir(want)
    assert run_dir == tmp_path / "logs" / "debug" / "runs" / "2026-01-02_03-04-05"
    assert run_dir.is_dir() and got.paths.output_dir == want.paths.output_dir == str(run_dir)
    assert got.paths.checkpoint_dir == str(run_dir / "checkpoint")
    assert got.to_container() == want.to_container()


def test_instantiate_retargets_to_the_port(tmp_path, monkeypatch):
    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path))
    cfg = config.compose(CONFIG_DIR, "train", ["logger=csv", "trainer.accelerator=cpu"])
    config.setup_run_dir(cfg)
    assert cfg.trainer._target_ == "msla_tpu.train.trainer.Trainer"  # configs/ as they are
    from msla_tpu_torch.data.datamodule import SlakhDataModule
    from msla_tpu_torch.models.vqvae import VQVAETask
    from msla_tpu_torch.train.callbacks import EarlyStopping, ModelCheckpoint
    from msla_tpu_torch.train.loggers import CSVLogger
    from msla_tpu_torch.train.trainer import Trainer

    assert type(config.instantiate(cfg.trainer)) is Trainer
    assert type(config.instantiate(cfg.data)) is SlakhDataModule
    assert type(config.instantiate(cfg.logger.csv)) is CSVLogger
    assert type(config.instantiate(cfg.callbacks.model_checkpoint)) is ModelCheckpoint
    assert type(config.instantiate(cfg.callbacks.early_stopping)) is EarlyStopping
    task = config.instantiate(cfg.model.vqvae, device="cpu", seed=0)
    assert type(task) is VQVAETask and task.hparams["num_embedding"] == 512
    assert config.get_class(cfg.model.bert._target_).__module__ == "msla_tpu_torch.models.bert"
    assert retarget("msla_tpu.x.Y") == "msla_tpu_torch.x.Y"
    assert retarget("collections.OrderedDict") == "collections.OrderedDict"


@pytest.mark.parametrize("logger,cls", [("tensorboard", "TensorBoardLogger"),
                                        ("wandb", "WandbLogger")])
def test_the_logger_targets_instantiate_and_write(tmp_path, monkeypatch, logger, cls):
    """configs/logger/{tensorboard,wandb}.yaml, which waited, build the
    port's loggers, which write into the run directory."""
    from msla_tpu_torch.train import loggers
    from msla_tpu_torch.utils.instantiators import instantiate_loggers

    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path))
    cfg = config.compose(CONFIG_DIR, "train", [f"logger={logger}"])
    config.setup_run_dir(cfg)
    lg, = instantiate_loggers(cfg.logger)
    assert type(lg) is getattr(loggers, cls)
    lg.log_metrics({"train/loss": 0.5}, 1)
    lg.finalize()
    out = Path(cfg.paths.output_dir)
    written = sorted(p.name for p in out.rglob("*") if p.is_file())
    want = "events.out.tfevents." if logger == "tensorboard" else "wandb_stub.jsonl"
    assert any(name.startswith(want) for name in written), written


def test_experiment_vqvae_slakh_composes_and_instantiates(tmp_path, monkeypatch):
    """The repository's example experiment: the full-width VQ-VAE at batch
    64 with the tensorboard logger, and the Trainer's keywords that waited."""
    from msla_tpu_torch.data.datamodule import SlakhDataModule
    from msla_tpu_torch.models.vqvae import VQVAETask
    from msla_tpu_torch.train.loggers import TensorBoardLogger
    from msla_tpu_torch.train.trainer import Trainer
    from msla_tpu_torch.utils.instantiators import instantiate_callbacks, instantiate_loggers

    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path))
    overrides = ["experiment=vqvae_slakh", "trainer.accelerator=cpu",
                 "+trainer.accumulate_grad_batches=2", "+trainer.remat=True",
                 "+trainer.profiler=jax"]
    cfg, want = _both(overrides)
    assert cfg.to_container(resolve=False) == want.to_container(resolve=False)
    config.setup_run_dir(cfg)
    assert cfg.task_name == "vqvae_slakh" and cfg.train_vqvae
    lg, = instantiate_loggers(cfg.get("logger"))
    assert type(lg) is TensorBoardLogger
    trainer = config.instantiate(cfg.trainer, callbacks=instantiate_callbacks(cfg.callbacks),
                                 logger=[lg])
    assert type(trainer) is Trainer and trainer.max_epochs == 10
    assert trainer.accumulate_grad_batches == 2 and trainer.remat and trainer._trace
    assert not trainer.profiler.enabled
    dm = config.instantiate(cfg.data)
    assert type(dm) is SlakhDataModule and cfg.data.batch_size == 64
    task = config.instantiate(cfg.model.vqvae, device="cpu", seed=0)
    assert type(task) is VQVAETask
    assert (task.hparams["num_hidden"], task.hparams["num_embedding"],
            task.hparams["embedding_dim"]) == (128, 512, 64)


def test_the_transformer_target_instantiates(tmp_path, monkeypatch):
    """configs/model/transformer.yaml's target, which waited for the
    transformer, builds the port's TransformerTask, and the MoE preset its
    experts."""
    from msla_tpu_torch.models.transformer import TransformerTask

    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path))
    cfg = config.compose(CONFIG_DIR, "train", ["experiment=moe_transformer",
                                               "data.target_sample_rate=64",
                                               "model.transformer.hidden_dim=16",
                                               "model.transformer.num_heads=2",
                                               "model.transformer.num_layers=1"])
    config.setup_run_dir(cfg)
    task = config.instantiate(cfg.model.transformer, device="cpu", seed=0, latent_channels=8)
    assert type(task) is TransformerTask and task.hparams["moe_experts"] == 8
    assert tuple(task.net.layer0.moe.w1.shape) == (8, 16, 2048)
    assert tuple(task.net.fc.weight.shape) == (128, 8 * 16 // 4)


@pytest.mark.parametrize("target", ["jax.numpy.zeros", "flax.linen.Dense",
                                    "msla_tpu_torch_x.y.Z"])
def test_a_target_outside_the_port_never_imports_jax(target):
    import sys

    with pytest.raises(config.InstantiationError):
        config.instantiate({"_target_": target, "shape": 1})
    assert "msla_tpu_torch_x" not in sys.modules


def test_every_configs_target_resolves_in_the_port():
    """Every ``_target_`` in configs/ is a class of the port, the sweep's
    included."""
    import re

    targets = {m for f in CONFIG_DIR.rglob("*.yaml")
               for m in re.findall(r"_target_:\s*(\S+)", f.read_text())}
    assert len(targets) >= 12
    for target in sorted(targets):
        assert config.get_class(target).__module__.startswith("msla_tpu_torch."), target
