"""The sweep under the launcher: ``python -m msla_tpu_torch.parallel.launch
--nproc 2 --platform cpu -- -m msla_tpu_torch -m hparams_search=optuna_smoke``
on the CPU, two gloo ranks, against the JAX package's sampler.

* Both ranks run the 2 trials with the same overrides, the JAX
  ``TPESampler``'s for the same values (trained here at
  ``tests/test_torch_sweep.py``'s TINY widths on a 4 kHz fixture, each trial
  over both ranks); one multirun directory, whose ``trial_result.json``
  files, ``optimization_results.yaml`` and trial logs rank 0 alone writes.
* A trial that raises on one rank ends the launch with a non-zero exit
  within a time limit: the other rank, waiting in the trial's collective,
  is stopped by the launcher and does not hang.
"""
import ast
import json
import os
import re
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import yaml

from msla_tpu.sweep import sampler as jax_sampler, space as jax_space
from msla_tpu_torch.data.dataset import make_fixture_dataset

REPO = Path(__file__).resolve().parent.parent
SR = 4000
TINY = ["model.vqvae.num_residual_hidden=8", "model.vqvae.num_embedding=16",
        "model.vqvae.embedding_dim=8", "model.vqvae.num_hidden=16"]
FAIL_LIMIT_S = 120      # a hang never ends; the launch ends in ~10 s alone

PLANTED = textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist
    from msla_tpu_torch import main as cli
    from msla_tpu_torch.parallel.mesh import process_info

    def run(cfg):
        if int(cfg.hydra.job.num) == 1 and process_info()[0] == 1:
            raise RuntimeError("planted failure of trial 1 on rank 1")
        t = torch.ones(1)
        dist.all_reduce(t)   # the trial's collective, where rank 0 waits for rank 1
        return float(cfg.model.vqvae.learning_rate)

    cli.run = run
    cli.main(sys.argv[1:])
""")


def _launch(args: list[str], project: Path, slakh: Path | None = None) -> subprocess.Popen:
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
           "PROJECT_ROOT": str(project)}
    if slakh is not None:
        env["SLAKH_DIR"] = str(slakh)
    return subprocess.Popen(
        [sys.executable, "-m", "msla_tpu_torch.parallel.launch", "--nproc", "2", "--platform",
         "cpu", "--", *args], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO)


def _params() -> dict:
    text = (REPO / "configs" / "hparams_search" / "optuna_smoke.yaml").read_text()
    return yaml.safe_load(text)["hydra"]["sweeper"]


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """Both launches at once: the planted failure and the trained sweep."""
    tmp = tmp_path_factory.mktemp("sweep_launch")
    for split in ("train", "validation", "test"):
        make_fixture_dataset(tmp / "slakh" / split, n_tracks=1, seconds=26, sr=SR)
    script = tmp / "planted.py"
    script.write_text(PLANTED)
    common = ["-m", "hparams_search=optuna_smoke", "extras.print_config=False",
              "visualize=False", "generate=False"]
    t0 = time.perf_counter()
    planted = _launch([str(script), *common], tmp / "planted")
    sweep = _launch(["-m", "msla_tpu_torch", *common, "train_vqvae=True",
                     "trainer.accelerator=cpu", f"data.target_sample_rate={SR}",
                     "data.batch_size=2", "trainer.max_epochs=1",
                     "+trainer.limit_train_batches=1", "+trainer.limit_val_batches=1",
                     "+trainer.limit_test_batches=1", *TINY], tmp / "project", tmp / "slakh")
    try:
        failed_out = planted.communicate(timeout=FAIL_LIMIT_S)[0]
        failed_s = time.perf_counter() - t0
        out = sweep.communicate(timeout=240)[0]
    finally:
        for p in (planted, sweep):
            if p.poll() is None:
                p.kill()
    assert sweep.returncode == 0, out[-6000:]
    trials = {r: [ast.literal_eval(p) for p in re.findall(
        rf"^\[rank {r}\] .*Trial \d/2: (\{{.*\}})$", out, re.M)] for r in (0, 1)}
    sweep_dir, = (tmp / "project" / "logs" / "train" / "multiruns").iterdir()
    return dict(planted=(planted.returncode, failed_s, failed_out), trials=trials,
                sweep_dir=sweep_dir)


def test_a_trial_that_fails_on_one_rank_ends_the_launch(launches):
    rc, seconds, out = launches["planted"]
    assert rc not in (0, None) and seconds < FAIL_LIMIT_S, out[-4000:]
    assert "[rank 1]" in out and "planted failure of trial 1 on rank 1" in out


def test_both_ranks_run_the_jax_samplers_trials(launches):
    trials, sweep_dir = launches["trials"], launches["sweep_dir"]
    assert len(trials[0]) == 2 and trials[0] == trials[1], trials
    values = [json.loads((sweep_dir / str(t) / "trial_result.json").read_text())["value"]
              for t in range(2)]
    cfg = _params()
    want = jax_sampler.TPESampler(seed=cfg["sampler"]["seed"],
                                  n_startup_trials=cfg["sampler"]["n_startup_trials"])
    space, seen = jax_space.parse_space(cfg["params"]), []
    for trial, value in zip(trials[0], values):
        assert want.sample(space, seen) == trial
        seen.append((trial, value))


def test_one_multirun_directory_written_by_rank_0(launches):
    trials, sweep_dir = launches["trials"], launches["sweep_dir"]
    assert sorted(p.name for p in sweep_dir.iterdir()) == ["0", "1",
                                                            "optimization_results.yaml"]
    values = []
    for trial in range(2):
        rec = json.loads((sweep_dir / str(trial) / "trial_result.json").read_text())
        assert rec["trial"] == trial and rec["params"] == trials[0][trial]
        values.append(rec["value"])
        log = (sweep_dir / str(trial) / "train.log").read_text()
        assert log.count(f"Trial {trial + 1}/2:") == 1   # rank 0's file alone
    result = yaml.safe_load((sweep_dir / "optimization_results.yaml").read_text())
    assert result["n_completed"] == 2 and result["best_value"] == min(values)
