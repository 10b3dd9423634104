"""The port's hyper-parameter sweep (``msla_tpu_torch.sweep``) against the JAX
package's (``msla_tpu.sweep``), on the CPU.

* ``parse_space`` on configs/hparams_search/optuna.yaml and optuna_smoke.yaml
  gives the JAX distributions;
* the TPE sampler's suggestions are the JAX sampler's bit for bit over 12
  trials fed the same values, through its start-up draws and its TPE phase;
  the shipped sweep's 10 trials (seed 1234) are the widths the card runs;
* ``TPESweeper.optimize`` on a deterministic objective writes the JAX
  sweeper's journal, ``trial_result.json`` files and
  ``optimization_results.yaml``; it resumes from its journal, refuses RDB
  URLs and skips a trial that raises, as ``tests/test_sweep.py`` holds the
  JAX one;
* ``python -m msla_tpu_torch -m hparams_search=optuna_smoke`` and
  ``hparams_search=optuna`` (MULTIRUN by its config) give the trial params
  and multirun layout of the JAX ``main.py``; the smoke sweep trains its
  trials on ``trainer.accelerator=cpu`` at tiny widths.
"""
import json
import logging
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import main as jax_main
from msla_tpu.sweep import sampler as jax_sampler, space as jax_space, sweeper as jax_sweeper
from msla_tpu_torch import main as cli
from msla_tpu_torch.data.dataset import make_fixture_dataset
from msla_tpu_torch.sweep import sampler, space, sweeper
from msla_tpu_torch.sweep.sweeper import TPESweeper, run_sweep

CONFIGS = ("optuna", "optuna_smoke")
SR = 4000
TINY = ["model.vqvae.num_residual_hidden=8", "model.vqvae.num_embedding=16",
        "model.vqvae.embedding_dim=8"]
#: (num_hidden, embedding_dim, num_embedding, batch_size) of the shipped
#: sweep's 10 trials, seed 1234, all start-up draws
SHIPPED = [(256, 64, 512, 64), (256, 256, 128, 256), (64, 128, 512, 256), (64, 256, 128, 32),
           (64, 64, 512, 128), (128, 64, 256, 32), (128, 256, 512, 256), (128, 256, 512, 32),
           (256, 256, 512, 256), (256, 64, 256, 32)]


def _params(name: str) -> dict:
    text = (cli.CONFIG_DIR / "hparams_search" / f"{name}.yaml").read_text()
    return yaml.safe_load(text)["hydra"]["sweeper"]["params"]


@pytest.fixture
def restore_logging():
    """A sweep configures the root logger for each trial, as JAX's does; put it back."""
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield
    for h in root.handlers:
        if h not in handlers:
            h.close()
    root.handlers[:], root.level = handlers, level


@pytest.mark.parametrize("name", CONFIGS)
def test_parse_space_matches_jax(name):
    got, want = space.parse_space(_params(name)), jax_space.parse_space(_params(name))
    assert list(got) == list(want)
    for key in want:
        assert type(got[key]).__name__ == type(want[key]).__name__
        assert vars(got[key]) == vars(want[key])
    assert space.parse_distribution("range(1, 7, 2)").choices == [1, 3, 5]
    assert space.parse_distribution("choice(a, 'b')").choices == ["a", "b"]


def _objective(params: dict) -> float:
    return sum((float(v) - 0.3) ** 2 if isinstance(v, float) else 0.01 * float(v)
               for v in params.values())


@pytest.mark.parametrize("name,seed", [("optuna", 1234), ("optuna_smoke", 7)])
def test_sampler_suggestions_bit_equal_to_jax(name, seed):
    """12 trials, 4 of them start-up draws, then TPE, each fed the same value."""
    got_s = sampler.TPESampler(seed=seed, n_startup_trials=4)
    want_s = jax_sampler.TPESampler(seed=seed, n_startup_trials=4)
    got_space = space.parse_space(_params(name))
    want_space = jax_space.parse_space(_params(name))
    got_obs, want_obs = [], []
    for _ in range(12):
        got, want = got_s.sample(got_space, got_obs), want_s.sample(want_space, want_obs)
        assert got == want and [type(v) for v in got.values()] == [type(v) for v in
                                                                    want.values()]
        got_obs.append((got, _objective(got)))
        want_obs.append((want, _objective(want)))


def test_shipped_sweep_trials_are_the_widths_the_card_runs():
    s = sampler.TPESampler(seed=1234, n_startup_trials=20)
    dists = space.parse_space(_params("optuna"))
    trials = [s.sample(dists, []) for _ in range(10)]
    assert [(t["model.vqvae.num_hidden"], t["model.vqvae.embedding_dim"],
             t["model.vqvae.num_embedding"], t["data.batch_size"]) for t in trials] == SHIPPED


def _config(tmp_path):
    (tmp_path / "cfgs").mkdir()
    (tmp_path / "cfgs" / "t.yaml").write_text(
        "task_name: sweeptest\nx: 0.0\nc: 1\npaths:\n  log_dir: %s\nhydra:\n  sweep:\n"
        "    dir: %s\n" % (tmp_path, tmp_path / "multirun"))
    return tmp_path / "cfgs"


def _sweep_files(root) -> dict:
    files = {}
    for path in sorted(root.rglob("*")):
        if path.suffix in (".json", ".yaml", ".jsonl") and "cfgs" not in path.parts:
            files[str(path.relative_to(root))] = path.read_text()
    return files


def test_optimize_writes_what_jax_writes(tmp_path, restore_logging):
    params = {"x": "interval(0, 1)", "c": "choice(1, 2, 3)"}

    def run_fn(cfg):
        return (float(cfg.x) - 0.3) ** 2 + 0.1 * int(cfg.c)

    out = {}
    for label, mod, smp in (("port", sweeper, sampler), ("jax", jax_sweeper, jax_sampler)):
        root = tmp_path / label
        root.mkdir()
        s = mod.TPESweeper(params=params, n_trials=9, direction="maximize", study_name="s",
                           sampler=smp.TPESampler(seed=3, n_startup_trials=4),
                           storage=str(root / "journal" / "study.jsonl"))
        out[label] = (s.optimize(_config(root), "t", [], run_fn), _sweep_files(root))
    assert out["port"][0] == out["jax"][0]
    assert out["port"][0]["n_completed"] == 9
    assert out["port"][1] == out["jax"][1]
    assert len([f for f in out["port"][1] if f.endswith("trial_result.json")]) == 9


def test_storage_resume_and_study_isolation(tmp_path, restore_logging):
    journal = tmp_path / "journal" / "study.jsonl"
    cfgs = _config(tmp_path)
    calls = []

    def run_fn(cfg):
        calls.append(float(cfg.x))
        return (float(cfg.x) - 0.3) ** 2

    def make(n, study="s1", seed=1):
        return TPESweeper(params={"x": "interval(0, 1)"}, n_trials=n, study_name=study,
                          sampler=sampler.TPESampler(seed=seed, n_startup_trials=3),
                          storage=str(journal))

    assert make(4).optimize(cfgs, "t", [], run_fn)["n_completed"] == 4 and len(calls) == 4
    r2 = make(7).optimize(cfgs, "t", [], run_fn)
    assert r2["n_completed"] == 7 and len(calls) == 7
    assert len(journal.read_text().splitlines()) == 7
    assert abs(r2["best_value"] - min((x - 0.3) ** 2 for x in calls)) < 1e-12
    assert make(7).optimize(cfgs, "t", [], run_fn)["n_completed"] == 7 and len(calls) == 7
    assert make(2, "s2", 2).optimize(cfgs, "t", [], run_fn)["n_completed"] == 2
    assert len(calls) == 9


def test_rdb_urls_and_a_missing_sweeper_raise(tmp_path):
    with pytest.raises(ValueError, match="RDB URLs"):
        TPESweeper(params={"x": "interval(0, 1)"}, storage="sqlite:///example.db")
    with pytest.raises(RuntimeError, match="no hydra.sweeper"):
        run_sweep(_config(tmp_path), "t", [], lambda cfg: 0.0)


def test_a_trial_that_raises_is_skipped(tmp_path, restore_logging):
    def run_fn(cfg):
        if float(cfg.x) > 0.5:
            raise RuntimeError("planted")
        return float(cfg.x)

    s = TPESweeper(params={"x": "interval(0, 1)"}, n_trials=6,
                   sampler=sampler.TPESampler(seed=0, n_startup_trials=6))
    result = s.optimize(_config(tmp_path), "t", [], run_fn)
    done = sorted((tmp_path / "multirun").glob("*/trial_result.json"))
    assert 0 < result["n_completed"] == len(done) < 6
    assert len(list((tmp_path / "multirun").glob("[0-9]"))) == 6
    assert yaml.safe_load((tmp_path / "multirun" / "optimization_results.yaml").read_text()) \
        == result


def _stub_sweep(module, argv, project, monkeypatch) -> tuple[list, dict]:
    """``module.main(argv)`` with its ``run`` replaced by a stub that records
    each trial's params and run directory (relative to the sweep dir)."""
    seen = []

    def run(cfg):
        v = cfg.model.vqvae
        seen.append(dict(lr=float(v.learning_rate), layers=int(v.num_residual_layer),
                         hidden=int(v.num_hidden), dim=int(v.embedding_dim),
                         codes=int(v.num_embedding), batch=int(cfg.data.batch_size),
                         epochs=int(cfg.trainer.max_epochs),
                         dir=str(cfg.hydra.runtime.output_dir)))
        return float(v.learning_rate) * 100 + int(v.num_residual_layer)

    monkeypatch.setenv("PROJECT_ROOT", str(project))
    monkeypatch.setattr(module, "run", run)
    best = module.main(argv)
    sweep_dir, = (project / "logs" / "train" / "multiruns").glob("*")
    for trial in seen:
        trial["dir"] = str(Path(trial["dir"]).relative_to(sweep_dir))
    return seen, dict(best=best, files=_sweep_files(sweep_dir),
                      dirs=sorted(str(p.relative_to(sweep_dir)) for p in sweep_dir.iterdir()))


@pytest.mark.parametrize("argv", [["-m", "hparams_search=optuna_smoke"],
                                  ["hparams_search=optuna"]], ids=["smoke -m", "optuna"])
def test_cli_multirun_matches_jax_main(tmp_path, monkeypatch, restore_logging, argv):
    argv = argv + ["extras.print_config=False"]
    got = _stub_sweep(cli, list(argv), tmp_path / "port", monkeypatch)
    want = _stub_sweep(jax_main, list(argv), tmp_path / "jax", monkeypatch)
    assert got == want
    trials, layout = got
    assert [t["dir"] for t in trials] == [str(i) for i in range(len(trials))]
    assert layout["dirs"] == sorted([str(i) for i in range(len(trials))]
                                    + ["optimization_results.yaml"])
    if argv[0] == "hparams_search=optuna":
        assert [(t["hidden"], t["dim"], t["codes"], t["batch"]) for t in trials] == SHIPPED
        assert {t["epochs"] for t in trials} == {20}


def test_cli_smoke_sweep_trains_on_the_cpu(tmp_path, monkeypatch, restore_logging):
    for split, n in [("train", 1), ("validation", 1), ("test", 1)]:
        make_fixture_dataset(tmp_path / "slakh" / split, n_tracks=n, seconds=26, sr=SR)
    monkeypatch.setenv("SLAKH_DIR", str(tmp_path / "slakh"))
    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path / "project"))
    best = cli.main(["-m", "hparams_search=optuna_smoke", "train_vqvae=True",
                     "trainer.accelerator=cpu", f"data.target_sample_rate={SR}",
                     "data.batch_size=2", "trainer.max_epochs=1",
                     "+trainer.limit_train_batches=1", "+trainer.limit_val_batches=1",
                     "+trainer.limit_test_batches=1", "model.vqvae.num_hidden=16", *TINY,
                     "extras.print_config=False", "visualize=False", "generate=False"])
    sweep_dir, = (tmp_path / "project" / "logs" / "train" / "multiruns").glob("*")
    result = yaml.safe_load((sweep_dir / "optimization_results.yaml").read_text())
    assert result["n_completed"] == 2 and result["best_value"] == best
    values = []
    for trial in range(2):
        rec = json.loads((sweep_dir / str(trial) / "trial_result.json").read_text())
        assert rec["trial"] == trial and set(rec["params"]) == set(_params("optuna_smoke"))
        assert math.isfinite(rec["value"])
        values.append(rec["value"])
    assert best == min(values)
    assert np.isfinite(best) and torch.get_default_dtype() == torch.float32


def test_the_sweep_trainer_settings_mean_one_card(tmp_path, monkeypatch):
    """optuna.yaml's trainer (accelerator: ddp, devices: -1, num_nodes: 1)
    is the port's one-card Trainer: none of the three is refused, and ddp
    asks for the card (absent here), as any accelerator but cpu does."""
    from msla_tpu_torch.config import compose, instantiate, setup_run_dir

    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path))
    cfg = compose(cli.CONFIG_DIR, "train", ["hparams_search=optuna"])
    setup_run_dir(cfg)
    assert (cfg.trainer.accelerator, cfg.trainer.devices, cfg.trainer.num_nodes) == ("ddp", -1, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        instantiate(cfg.trainer)
    cfg.update_dotted("trainer.accelerator", "cpu")
    assert instantiate(cfg.trainer).device == torch.device("cpu")
