"""Run-directory and project-root management (the port's copy of
msla_tpu/config/runtime.py).

Covers what the reference gets from ``rootutils.setup_root`` (reference:
src/main.py:16) and Hydra's run-dir templating (reference:
configs/hydra/default.yaml:9-18): find the ``.project-root`` marker, export
``PROJECT_ROOT``, and materialize ``hydra.runtime.{output_dir,cwd}`` from the
``hydra.run.dir`` template so ``${hydra:runtime.output_dir}`` interpolations
resolve (reference: configs/paths/default.yaml:9-10).
"""
from __future__ import annotations

import logging
import os
from pathlib import Path

from msla_tpu_torch.config.node import ConfigNode


def setup_root(start: str | Path | None = None, indicator: str = ".project-root") -> Path:
    """Walk up from ``start`` to the directory containing ``indicator``."""
    path = Path(start or os.getcwd()).resolve()
    if path.is_file():
        path = path.parent
    for candidate in [path, *path.parents]:
        if (candidate / indicator).exists():
            os.environ.setdefault("PROJECT_ROOT", str(candidate))
            return candidate
    # fall back to the starting directory rather than failing hard
    os.environ.setdefault("PROJECT_ROOT", str(path))
    return path


def setup_run_dir(cfg: ConfigNode, job_num: int | None = None) -> Path:
    """Create the run directory from the hydra template and record runtime info."""
    if "hydra" not in cfg:
        cfg["hydra"] = {}
    hydra_cfg = cfg["hydra"]

    if job_num is None:
        template = hydra_cfg.select("run.dir") or "${paths.log_dir}/${task_name}/runs/${now:%Y-%m-%d_%H-%M-%S}"
        run_dir = Path(str(template))
    else:
        sweep_dir = hydra_cfg.select("sweep.dir") or "${paths.log_dir}/${task_name}/multiruns/${now:%Y-%m-%d_%H-%M-%S}"
        run_dir = Path(str(sweep_dir)) / str(job_num)

    run_dir.mkdir(parents=True, exist_ok=True)
    if "runtime" not in hydra_cfg:
        hydra_cfg["runtime"] = {}
    hydra_cfg["runtime"]["output_dir"] = str(run_dir)
    hydra_cfg["runtime"]["cwd"] = os.getcwd()
    if "job" not in hydra_cfg:
        hydra_cfg["job"] = {}
    hydra_cfg["job"]["num"] = job_num if job_num is not None else 0
    return run_dir


def setup_job_logging(cfg: ConfigNode, task_name: str, to_file: bool = True) -> None:
    """File + console logging per run, standing in for hydra job_logging;
    the file only ``to_file`` (one rank's, where ranks share the run dir)."""
    output_dir = cfg.select("hydra.runtime.output_dir")
    handlers: list[logging.Handler] = [logging.StreamHandler()]
    if output_dir and to_file:
        handlers.append(logging.FileHandler(Path(str(output_dir)) / f"{task_name}.log"))
    level_name = cfg.select("hydra.job_logging.root.level", "INFO")
    logging.basicConfig(
        level=getattr(logging, str(level_name).upper(), logging.INFO),
        format="[%(asctime)s][%(name)s][%(levelname)s] - %(message)s",
        handlers=handlers,
        force=True,
    )
