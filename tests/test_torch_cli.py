"""The port's command line, ``python -m msla_tpu_torch``, on the CPU.

* ``debug=default train_vqvae=True`` on fixture WAVs exits 0 in a
  subprocess, with the run directory and ``debug.log`` where JAX's CLI puts
  them, the simple profiler's report, and generate/visualize skipping;
* a full (non-debug) CPU run writes ``best_vqvae.ckpt``, ``last.ckpt``,
  ``codebook.csv``, the demo WAVs and the SVGs under the names JAX's
  ``visualize`` gives them; after it, no module of ``msla_tpu``, JAX or flax
  is in the subprocess's ``sys.modules``;
* ``plot_embeddings_from_quantized``'s used codes per instrument equal the
  JAX task's on the same weights (``vqvae_state_dict_from_jax``);
* ``generate`` corrupts the stem and draws the noise JAX's ``generate`` draws
  after the same ``seed_everything`` (bit for bit), through a small BERT;
* ``train_transformer=True``, then with ``experiment=moe_transformer``,
  after a ``train_vqvae=True`` run trains the transformer (2 layers, hidden
  32) over the frozen teacher's quantized latents, tests, and writes
  ``best_transformer.ckpt`` (the MoE run's with its 8 experts) beside the
  ``last.ckpt`` of the same run, no write left pending;
* ``train_bert=True`` after a ``train_vqvae=True`` run trains Audio-BERT (a
  small BERT) over the frozen ``best_vqvae.ckpt``, tests, writes
  ``best_bert.ckpt`` (the head and AdamW's state) with one ``frozen-*.ckpt``
  sidecar (BERT and the codebook, bit-unchanged from their init) and the
  audio demo, and ``generate`` reads them; without ``best_vqvae.ckpt`` it
  raises;
* ``experiment=vqvae_slakh`` runs with its TensorBoard logger, whose event
  files hold every scalar the Trainer logged, at its step;
* only a checkpoint that does not fit the config is caught, and two pipeline
  stages in one process raise JAX's ValueError.
"""
import functools
import logging
import os
import random
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import main as jax_main
from msla_tpu.models.vqvae import VQVAETask as JaxVQVAETask
from msla_tpu.utils import plotting as jax_plotting
from msla_tpu_torch import main as cli
from msla_tpu_torch.config import ConfigNode, compose, setup_run_dir
from msla_tpu_torch.data.dataset import make_fixture_dataset
from msla_tpu_torch.data.wavio import read_wav, write_wav
from msla_tpu_torch.models.bert import AudioBertTask
from msla_tpu_torch.models.vqvae import VQVAETask
from msla_tpu_torch.nn.bert import BertConfig
from msla_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from msla_tpu_torch.utils.jax_compat import vqvae_state_dict_from_jax
from msla_tpu_torch.utils.plotting import plot_embeddings_from_quantized

REPO = Path(__file__).resolve().parents[1]
SR = 4000
SVGS = sorted([f"{n}_{kind}.svg" for n in ("bass", "drums", "guitar", "piano", "song")
               for kind in ("spectrogram", "waveform")]
              + [f"{n}_embeddings_quantized_representation.svg"
                 for n in ("bass", "drums", "guitar", "piano")] + ["codebook.svg"])
SMALL_VQ = ["model.vqvae.num_hidden=16", "model.vqvae.num_residual_hidden=8",
            "model.vqvae.num_embedding=16", "model.vqvae.embedding_dim=8"]
SMALL_BERT = BertConfig(vocab_size=120, hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=2, intermediate_size=64)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("slakh_cli_port")
    for split, n in [("train", 2), ("validation", 2), ("test", 1)]:
        make_fixture_dataset(root / split, n_tracks=n, seconds=26, sr=SR)
    return root


@pytest.fixture
def restore_logging():
    """main() configures the root logger for its run, as JAX's does; put it back."""
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield
    for h in root.handlers:
        if h not in handlers:
            h.close()
    root.handlers[:], root.level = handlers, level


def _env(fixture_root, project):
    env = dict(os.environ, SLAKH_DIR=str(fixture_root), PROJECT_ROOT=str(project))
    env.pop("JAX_PLATFORMS", None)
    return env


def test_cli_debug_vqvae(fixture_root, tmp_path):
    result = subprocess.run(
        [sys.executable, "-m", "msla_tpu_torch", "debug=default", "train_vqvae=True",
         f"data.target_sample_rate={SR}", "data.batch_size=2"],
        cwd=str(REPO), env=_env(fixture_root, tmp_path), capture_output=True, text=True,
        timeout=300)
    assert result.returncode == 0, result.stderr[-3000:]
    out = result.stdout + result.stderr
    assert "generate: skipping" in out and "visualize: skipping" in out
    assert "Profiler report (wall-clock)" in out
    logs = list((tmp_path / "logs" / "debug" / "runs").glob("*/debug.log"))
    assert len(logs) == 1 and "Profiler report" in logs[0].read_text()


_RUN_AND_LIST_FOREIGN = """
import runpy, sys
sys.argv = ["msla_tpu_torch"] + sys.argv[1:]
runpy.run_module("msla_tpu_torch", run_name="__main__", alter_sys=True)
foreign = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("msla_tpu", "jax", "jaxlib", "flax", "optax"))
print("FOREIGN MODULES:", foreign)
sys.exit(3 if foreign else 0)
"""


def test_cli_run_writes_the_artifacts_and_imports_no_jax(fixture_root, tmp_path):
    result = subprocess.run(
        [sys.executable, "-c", _RUN_AND_LIST_FOREIGN, "train_vqvae=True",
         "trainer.accelerator=cpu", "trainer.max_epochs=1", "logger=csv",
         f"data.target_sample_rate={SR}", "data.batch_size=2", *SMALL_VQ],
        cwd=str(REPO), env=_env(fixture_root, tmp_path), capture_output=True, text=True,
        timeout=300)
    assert result.returncode == 0, (result.stdout + result.stderr)[-3000:]
    assert "FOREIGN MODULES: []" in result.stdout
    best = tmp_path / "logs" / "best_checkpoint"
    for name in ("best_vqvae.ckpt", "last.ckpt", "codebook.csv"):
        assert (best / name).is_file(), name
    codebook = np.loadtxt(best / "codebook.csv", delimiter=",", skiprows=1)
    assert codebook.shape == (16, 8)
    assert sorted(p.name for p in (tmp_path / "logs" / "plot_dir").glob("*.svg")) == SVGS
    run_dir, = (tmp_path / "logs" / "train" / "runs").glob("*")
    for kind in ("original", "generated"):
        for n in ("bass", "drums", "guitar", "piano", "full_song"):
            audio, rate = read_wav(run_dir / "checkpoint" / f"{kind}_{n}.wav")
            assert rate == SR and audio.shape == (1, 2 * SR)
    header = (run_dir / "csv" / "metrics.csv").read_text().splitlines()[0].split(",")
    assert "test/loss" in header and "validation/loss" in header
    assert "generate: skipping" in result.stderr


def test_used_codes_match_jax(tmp_path):
    cfg_model = dict(num_hidden=16, num_residual_layer=2, num_residual_hidden=8,
                     num_embedding=16, embedding_dim=8, commitment_cost=0.25,
                     learning_rate=1e-4, sample_rate=1000)
    paths = dict(checkpoint_dir=str(tmp_path), codebook_file=str(tmp_path / "codebook.csv"))
    rng = np.random.default_rng(11)
    instruments = (rng.standard_normal((1, 4, 800)) * 0.3).astype(np.float32)
    jax_task = JaxVQVAETask(**cfg_model, **paths)
    model_in = np.broadcast_to(instruments.sum(1, keepdims=True), instruments.shape)
    params = jax_task.init_variables(jax.random.PRNGKey(3),
                                     (jnp.asarray(model_in), jnp.asarray(instruments)))["params"]
    codebook = np.asarray(params["vector_quantizer"]["codebook"])
    np.savetxt(paths["codebook_file"], codebook, delimiter=",",
               header=",".join(str(i) for i in range(codebook.shape[1])), comments="")
    task = VQVAETask(**cfg_model, **paths, device="cpu")
    task.net.load_state_dict(vqvae_state_dict_from_jax(params, 2))
    cfg = ConfigNode({"paths": {"codebook_file": paths["codebook_file"],
                                "plot_dir": str(tmp_path / "port")}})
    mixed = instruments[0].sum(0).reshape(1, 1, -1)
    used = plot_embeddings_from_quantized(cfg, (mixed, instruments), task)
    for idx, name in enumerate(("bass", "drums", "guitar", "piano")):
        one = jnp.asarray(np.stack([instruments[:, idx, :].squeeze()] * 4)[None])
        want = np.unique(np.asarray(jax_task.get_quantized(params, one).encoding_indices))
        np.testing.assert_array_equal(used[name], want, err_msg=name)
    jax_cfg = ConfigNode({"paths": {"codebook_file": paths["codebook_file"],
                                    "plot_dir": str(tmp_path / "jax")}})
    jax_plotting.plot_embeddings_from_quantized(jax_cfg, (mixed, instruments), params=params,
                                                task=jax_task)
    assert sorted(p.name for p in (tmp_path / "port").glob("*.svg")) == \
        sorted(p.name for p in (tmp_path / "jax").glob("*.svg"))


def _generate_cfg(fixture_root, tmp_path, monkeypatch):
    monkeypatch.setenv("SLAKH_DIR", str(fixture_root))
    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path))
    monkeypatch.setattr(AudioBertTask, "__init__",
                        functools.partialmethod(AudioBertTask.__init__, config=SMALL_BERT))
    cfg = compose(cli.CONFIG_DIR, "train", ["trainer.accelerator=cpu",
                                            f"data.target_sample_rate={SR}", *SMALL_VQ])
    setup_run_dir(cfg)
    vqvae = cli.make_task(cfg, "vqvae")
    best = Path(str(cfg.paths.best_checkpoint_dir))
    save_checkpoint(best / "best_vqvae.ckpt", state_dict=vqvae.net.state_dict())
    vqvae.on_train_epoch_end(None)  # the codebook CSV
    save_checkpoint(best / "best_bert.ckpt",
                    state_dict=cli.make_task(cfg, "bert").net.state_dict())
    return cfg


@pytest.mark.parametrize("seed", [42, 7])
def test_generate_draws_what_jax_draws(fixture_root, tmp_path, monkeypatch, seed):
    cfg = _generate_cfg(fixture_root, tmp_path, monkeypatch)
    cli.seed_everything(seed)
    cli.generate(cfg)
    jax_main.seed_everything(seed)  # main.py:195-199, after its own seed_everything
    idx = random.randint(0, 3)
    noise = np.random.random(2 * SR).astype(np.float32)
    ckpt_dir = Path(str(cfg.paths.checkpoint_dir))
    write_wav(tmp_path / "want.wav", noise[None], SR)
    assert (ckpt_dir / "random_instrument.wav").read_bytes() == \
        (tmp_path / "want.wav").read_bytes()
    instruments = np.asarray(next(iter(cli.instantiate(cfg.data, batch_size=1)
                                       .predict_dataloader())))
    generated, rate = read_wav(ckpt_dir / "bert_generated_during_evaluation.wav")
    assert rate == SR and generated.shape == (1, 2 * SR) and np.isfinite(generated).all()
    cli.seed_everything(seed)
    corrupted, got_idx = cli.corrupt(instruments)
    assert got_idx == idx
    np.testing.assert_array_equal(corrupted[:, idx], noise[None])
    keep = [i for i in range(4) if i != idx]
    np.testing.assert_array_equal(corrupted[:, keep], instruments[:, keep])


def test_only_a_checkpoint_that_does_not_fit_is_caught(fixture_root, tmp_path, monkeypatch,
                                                        caplog):
    cfg = _generate_cfg(fixture_root, tmp_path, monkeypatch)
    best = Path(str(cfg.paths.best_checkpoint_dir))
    other = compose(cli.CONFIG_DIR, "train", ["trainer.accelerator=cpu"])  # full width
    save_checkpoint(best / "best_vqvae.ckpt",
                    state_dict=cli.make_task(other, "vqvae").net.state_dict())
    with caplog.at_level(logging.WARNING, logger="msla_tpu_torch.main"):
        assert cli.run(cfg) is None
    warnings = [r.getMessage() for r in caplog.records]
    assert any("generate failed" in w and "does not fit the config" in w for w in warnings)
    assert any("visualize failed" in w for w in warnings)

    def broken(cfg):
        raise RuntimeError("conv_stem kernel launch failed: CUDA error 700")

    monkeypatch.setattr(cli, "generate", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        cli.run(cfg)


def test_cli_trains_audio_bert_after_the_vqvae(fixture_root, tmp_path, monkeypatch,
                                               restore_logging):
    monkeypatch.setenv("SLAKH_DIR", str(fixture_root))
    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path))
    monkeypatch.setattr(AudioBertTask, "__init__",
                        functools.partialmethod(AudioBertTask.__init__, config=SMALL_BERT))
    common = ["trainer.accelerator=cpu", f"data.target_sample_rate={SR}", "data.batch_size=2",
              *SMALL_VQ, "extras.print_config=False"]
    with pytest.raises(FileNotFoundError, match="best_vqvae.ckpt"):
        cli.main(["train_bert=True", *common])
    cli.main(["train_vqvae=True", "trainer.max_epochs=1", "+generate=False",
              "+visualize=False", *common])
    test_loss = cli.main(["train_bert=True", "logger=csv", "+visualize=False",
                          "+optimized_metric=test/loss", *common])
    assert np.isfinite(test_loss)

    best = tmp_path / "logs" / "best_checkpoint"
    sidecar, = best.glob("frozen-*.ckpt")
    payload = load_checkpoint(best / "best_bert.ckpt")
    assert torch.load(best / "best_bert.ckpt", weights_only=True)["frozen_file"] == sidecar.name
    assert payload["epoch"] >= 1 and payload["opt_state"]["state"]
    cfg = compose(cli.CONFIG_DIR, "train", ["train_bert=True", *common])
    init = cli.make_task(cfg, "bert").net.state_dict()
    for key, value in payload["state_dict"].items():
        assert torch.equal(value, init[key]) != key.startswith("head."), key

    run_dir = sorted((tmp_path / "logs" / "train" / "runs").glob("*"))[-1]
    ckpt = run_dir / "checkpoint"
    for name in ("generated_full_song.wav", "bert_generated_during_evaluation.wav"):
        audio, rate = read_wav(ckpt / name)
        assert rate == SR and audio.shape == (1, 2 * SR) and np.isfinite(audio).all(), name
    header = (run_dir / "csv" / "metrics.csv").read_text().splitlines()[0].split(",")
    assert "test/si_sdr_full_audio_measure" in header and "train/loss" in header


def test_experiment_vqvae_slakh_logs_to_tensorboard(fixture_root, tmp_path, monkeypatch,
                                                    restore_logging):
    """``experiment=vqvae_slakh`` (its tensorboard logger) at small widths:
    the event files, read with tensorboard's loader, hold the hparams and
    every scalar the Trainer logged, at its step: each epoch's train and
    validation metrics, then the test's (in a second file: ``fit`` closes
    the logger, as the JAX Trainer's ``finalize`` would)."""
    from tensorboard.backend.event_processing.event_file_loader import EventFileLoader

    monkeypatch.setenv("SLAKH_DIR", str(fixture_root))
    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path))
    logged = []
    from msla_tpu_torch.train.loggers import TensorBoardLogger
    real = TensorBoardLogger.log_metrics
    monkeypatch.setattr(TensorBoardLogger, "log_metrics", lambda self, m, step: (
        logged.extend((k, step) for k in m), real(self, m, step)))
    test_loss = cli.main(["experiment=vqvae_slakh", "trainer.accelerator=cpu",
                          "trainer.max_epochs=2", f"data.target_sample_rate={SR}",
                          "data.batch_size=2", *SMALL_VQ, "model.vqvae.num_residual_hidden=8",
                          "+generate=False", "+visualize=False", "extras.print_config=False",
                          "+optimized_metric=test/loss"])
    assert np.isfinite(test_loss)
    run_dir, = (tmp_path / "logs" / "vqvae_slakh" / "runs").glob("*")
    files = sorted((run_dir / "tensorboard").glob("events.out.tfevents.*"))
    assert files
    events = [e for f in files for e in EventFileLoader(str(f)).Load()]
    scalars = [(v.tag, e.step) for e in events for v in e.summary.value
               if v.metadata.plugin_data.plugin_name == "scalars"]
    assert scalars == logged and ("test/loss", logged[-1][1]) in scalars
    assert {"train/loss", "validation/loss"} <= {tag for tag, _ in scalars}
    assert sorted({step for _, step in scalars}) == [5, 10]  # 5 batches an epoch
    text, = [v for e in events for v in e.summary.value if v.tag == "hparams/text_summary"]
    assert '"num_embedding": 16' in text.tensor.string_val[0].decode()


def test_cli_trains_the_transformer_after_the_vqvae(fixture_root, tmp_path, monkeypatch,
                                                   restore_logging):
    from msla_tpu_torch.train import checkpoint

    monkeypatch.setenv("SLAKH_DIR", str(fixture_root))
    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path))
    common = ["trainer.accelerator=cpu", f"data.target_sample_rate={SR}", "data.batch_size=2",
              *SMALL_VQ, "model.transformer.num_layers=2", "model.transformer.num_heads=4",
              "model.transformer.hidden_dim=32", "+generate=False", "+visualize=False",
              "extras.print_config=False"]
    with pytest.raises(FileNotFoundError, match="best_vqvae.ckpt"):
        cli.main(["train_transformer=True", *common])
    cli.main(["train_vqvae=True", "trainer.max_epochs=1", *common])
    best = tmp_path / "logs" / "best_checkpoint"
    for extra, experts in (([], 0), (["experiment=moe_transformer"], 8)):
        test_loss = cli.main(["train_transformer=True", "trainer.max_epochs=1", "logger=csv",
                              "+optimized_metric=testing/loss", *extra, *common])
        assert np.isfinite(test_loss) and not checkpoint._pending
        payload = load_checkpoint(best / "best_transformer.ckpt")
        assert payload["epoch"] == 1 and payload["opt_state"]["state"]
        assert payload["hparams"]["moe_experts"] == experts
        assert ("layer0.moe.w1" in payload["state_dict"]) == bool(experts)
        assert payload["state_dict"]["fc.weight"].shape == (2 * SR, 8 * 32 // 4)
        task_name = "moe_transformer" if experts else "train"
        run_dir = sorted((tmp_path / "logs" / task_name / "runs").glob("*"))[-1]
        header = (run_dir / "csv" / "metrics.csv").read_text().splitlines()[0].split(",")
        assert "testing/si_sdr_full_audio_measure" in header and "train/loss" in header
        assert ("train/moe_aux" in header) == bool(experts)
        audio, rate = read_wav(run_dir / "checkpoint" / "generated_full_song.wav")
        assert rate == SR and audio.shape == (1, 2 * SR) and np.isfinite(audio).all()


@pytest.mark.parametrize("argv,item", [(["train_vqvae=True", "trainer.accelerator=cpu",
                                         "+trainer.pipeline_parallel=2"],
                                        "1 devices not divisible by the model-axis size 2")])
def test_commands_that_wait_raise(tmp_path, monkeypatch, restore_logging, argv, item):
    """The pipeline is ported: in one process (a world of one) two stages
    raise JAX's ValueError for a world the model axis does not divide."""
    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path))
    with pytest.raises(ValueError, match=item):
        cli.main(argv + ["+generate=False", "+visualize=False", "extras.print_config=False"])


def test_the_device_comes_from_the_accelerator(tmp_path, monkeypatch):
    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path))
    cpu = compose(cli.CONFIG_DIR, "train", ["trainer.accelerator=cpu", *SMALL_VQ, "seed=5"])
    task = cli.make_task(cpu, "vqvae")
    assert task.device.type == "cpu"
    again = cli.make_task(cpu, "vqvae")
    assert all(torch.equal(a, b) for a, b in zip(task.net.parameters(), again.net.parameters()))
    card = compose(cli.CONFIG_DIR, "train", SMALL_VQ)  # accelerator: tpu, the card
    assert cli.device_of(card) == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.make_task(card, "vqvae")
