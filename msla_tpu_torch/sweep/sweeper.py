"""Hyper-parameter sweeper (the port's copy of msla_tpu/sweep/sweeper.py,
which stands in for hydra's OptunaSweeper; ``python -m msla_tpu_torch -m
hparams_search=optuna``).

Runs ``n_trials`` composed-config jobs, each in its own multirun
subdirectory, with overrides drawn from the search space by the TPESampler,
and minimises or maximises what the run returns (``optimized_metric``).
Trials run one after another: ``n_jobs`` is kept for the config's sake and
acts as 1. A trial that raises is logged and skipped, as in the JAX sweeper;
``n_completed`` in ``optimization_results.yaml`` counts the trials that gave
a value.

Under the launcher every rank runs the sweep, as every JAX process does
(main.py:303-321), and each trial trains over all the ranks. The ranks take
rank 0's sweep directory (each ``compose`` resolves ``${now:...}`` on its
own clock), rank 0's sampled overrides and rank 0's value of each trial
(``parallel.mesh.broadcast_object``); rank 0 alone reads the journal and
writes it, ``trial_result.json``, ``optimization_results.yaml`` and the
trials' log files. A trial that raises on any rank ends the sweep with that
error there, and the launcher stops the others: a rank that skipped ahead
while its peers wait in the trial's collectives would hang (ROADMAP.md §3).
"""
from __future__ import annotations

import json
import logging
import math
from pathlib import Path
from typing import Callable

import yaml

from msla_tpu_torch.config import compose, instantiate, setup_job_logging, setup_run_dir
from msla_tpu_torch.parallel.mesh import broadcast_object, is_main_process, process_info
from msla_tpu_torch.sweep.sampler import TPESampler
from msla_tpu_torch.sweep.space import parse_space

log = logging.getLogger(__name__)


class TPESweeper:
    def __init__(self, params: dict | None = None, n_trials: int = 10, n_jobs: int = 1,
                 direction: str = "minimize", sampler: TPESampler | None = None,
                 storage=None, study_name: str | None = None):
        self.space = parse_space(dict(params or {}))
        self.n_trials = int(n_trials)
        self.n_jobs = int(n_jobs)  # the config's; trials run one after another
        self.direction = direction
        self.sampler = sampler or TPESampler()
        self.study_name = study_name
        self.observations: list[tuple[dict, float]] = []
        # `storage` is optuna's study persistence: a JSONL journal of the
        # completed trials, appended as each ends and read back by the next
        # sweep with the same storage and study_name, whose trials then count
        # towards n_trials and seed the sampler (a resume). Anything but a
        # filesystem path (optuna's RDB URLs) raises.
        self.storage = self._resolve_storage(storage)

    @staticmethod
    def _resolve_storage(storage) -> Path | None:
        if storage is None:
            return None
        s = str(storage)
        if "://" in s:
            raise ValueError(
                f"storage={s!r}: RDB URLs are not supported — pass a "
                "filesystem path for the JSONL trial journal (or null)")
        return Path(s)

    def _load_journal(self) -> list[dict]:
        """This study's completed trials in the storage journal."""
        if self.storage is None or not self.storage.exists():
            return []
        study = self.study_name or "sweep"
        with open(self.storage) as fh:
            records = [json.loads(line) for line in fh if line.strip()]
        return [rec for rec in records if rec.get("study", "sweep") == study]

    def _append_journal(self, trial: int, params: dict, value: float) -> None:
        if self.storage is None:
            return
        self.storage.parent.mkdir(parents=True, exist_ok=True)
        with open(self.storage, "a") as fh:
            fh.write(json.dumps({"study": self.study_name or "sweep", "trial": trial,
                                 "params": params, "value": value}) + "\n")

    def _signed(self, value: float) -> float:
        return value if self.direction == "minimize" else -value

    def optimize(self, config_dir, config_name: str, base_overrides: list[str],
                 run_fn: Callable) -> dict:
        main, launched = is_main_process(), process_info()[1] > 1
        best = {"value": math.inf, "params": None, "trial": None}
        sweep_dir = None
        resumed = broadcast_object(self._load_journal() if main else None)
        for rec in resumed:  # journal trials seed TPE and count towards n_trials
            signed = self._signed(float(rec["value"]))
            self.observations.append((rec["params"], signed))
            if signed < best["value"]:
                best = {"value": signed, "params": rec["params"], "trial": rec["trial"]}
        if resumed:
            log.info("Resumed %d completed trial(s) from %s (study=%s)",
                     len(resumed), self.storage, self.study_name or "sweep")
        for trial in range(len(resumed), self.n_trials):
            sampled = broadcast_object(self.sampler.sample(self.space, self.observations))
            trial_overrides = [f"{k}={v}" for k, v in sampled.items()]
            cfg = compose(config_dir, config_name, base_overrides + trial_overrides)
            if sweep_dir is None and launched:   # rank 0's clock names the directory
                sweep_dir = broadcast_object(
                    str(setup_run_dir(cfg, job_num=trial).parent) if main else None)
            if sweep_dir is not None:
                # every trial in the first trial's sweep dir: each compose
                # resolves ${now:...} anew
                cfg.update_dotted("hydra.sweep.dir", str(sweep_dir))
            run_dir = setup_run_dir(cfg, job_num=trial)
            sweep_dir = run_dir.parent
            setup_job_logging(cfg, str(cfg.task_name), to_file=main)
            log.info("Trial %d/%d: %s", trial + 1, self.n_trials, sampled)
            try:
                value = run_fn(cfg)
            except Exception as err:
                if launched:   # its peers may wait in a collective: end here
                    raise
                log.exception("Trial %d failed: %s", trial, err)
                continue
            value = broadcast_object(value)
            if value is None:
                log.warning("Trial %d returned no objective (optimized_metric unset?)", trial)
                continue
            signed = self._signed(float(value))
            self.observations.append((sampled, signed))
            if signed < best["value"]:
                best = {"value": signed, "params": sampled, "trial": trial}
            if main:
                with open(run_dir / "trial_result.json", "w") as f:
                    json.dump({"trial": trial, "params": sampled, "value": float(value)}, f)
                self._append_journal(trial, sampled, float(value))

        found = best["params"] is not None
        result = {
            "name": self.study_name or "sweep",
            "direction": self.direction,
            "best_trial": best["trial"],
            "best_value": (best["value"] if self.direction == "minimize" else -best["value"])
            if found else None,
            "best_params": best["params"],
            "n_completed": len(self.observations),
        }
        if sweep_dir is not None and main:
            with open(sweep_dir / "optimization_results.yaml", "w") as f:
                yaml.safe_dump(result, f)
        log.info("Sweep finished: %s", result)
        return result


def run_sweep(config_dir, config_name: str, overrides: list[str],
              run_fn: Callable) -> float | None:
    """What ``python -m msla_tpu_torch -m`` runs: the sweeper built from
    ``hydra.sweeper``, over ``run_fn``; returns the best value."""
    cfg = compose(config_dir, config_name, overrides)
    sweeper_cfg = cfg.select("hydra.sweeper")
    if sweeper_cfg is None:
        raise RuntimeError("multirun requested but no hydra.sweeper configured "
                           "(use hparams_search=optuna)")
    sweeper: TPESweeper = instantiate(sweeper_cfg)
    return sweeper.optimize(config_dir, config_name, overrides, run_fn).get("best_value")
