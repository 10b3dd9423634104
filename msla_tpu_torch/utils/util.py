"""Run utilities (the port's copy of msla_tpu/utils/util.py; reference:
src/utils/util.py:22-208): extras (warnings, tag enforcement, config-tree
print), task_wrapper (exception logging + logger cleanup), get_metric_value
(sweep objective extraction)."""
from __future__ import annotations

import functools
import warnings
from pathlib import Path
from typing import Callable

from msla_tpu_torch.config import ConfigNode
from msla_tpu_torch.utils.pylogger import RankedLogger

log = RankedLogger(__name__, rank_zero_only=True)

_CONFIG_GROUP_ORDER = ("data", "model", "callbacks", "logger", "trainer",
                       "paths", "extras")


def print_config_tree(cfg: ConfigNode, save_to_file: bool = True) -> None:
    """Pretty-print the composed config (reference: util.py:136-183)."""
    try:
        import rich
        import rich.tree
        import rich.syntax
        import yaml

        tree = rich.tree.Tree("CONFIG", style="dim")
        queue = [g for g in _CONFIG_GROUP_ORDER if g in cfg]
        queue += [k for k in cfg.keys() if k not in queue and k != "hydra"]
        for field in queue:
            branch = tree.add(field, style="dim")
            value = cfg.get(field)
            if isinstance(value, ConfigNode):
                content = yaml.dump(value.to_container(resolve=True), sort_keys=False)
            else:
                content = str(value)
            branch.add(rich.syntax.Syntax(content, "yaml"))
        rich.print(tree)
        if save_to_file:
            output_dir = cfg.select("paths.output_dir")
            if output_dir:
                with open(Path(str(output_dir)) / "config_tree.log", "w") as f:
                    rich.print(tree, file=f)
    except Exception as err:  # config printing must never kill a run
        log.warning(f"print_config_tree failed: {err}")


def enforce_tags(cfg: ConfigNode, save_to_file: bool = True) -> None:
    """Require tags (reference: util.py:186-208). In non-interactive runs a
    missing tags list is filled with ['dev'] instead of prompting."""
    if not cfg.get("tags"):
        log.warning("No tags provided in config — defaulting to ['dev']")
        cfg["tags"] = ["dev"]
    if save_to_file:
        output_dir = cfg.select("paths.output_dir")
        if output_dir:
            with open(Path(str(output_dir)) / "tags.log", "w") as f:
                f.write("\n".join(str(t) for t in cfg.tags))


def extras(cfg: ConfigNode) -> None:
    """Warning suppression, tag enforcement, rich config print
    (reference: util.py:22-55)."""
    if not cfg.get("extras"):
        log.warning("Extras config not found! <cfg.extras=null>")
        return
    if cfg.extras.get("ignore_warnings"):
        log.info("Disabling python warnings! <cfg.extras.ignore_warnings=True>")
        warnings.filterwarnings("ignore")
    if cfg.extras.get("enforce_tags"):
        log.info("Enforcing tags! <cfg.extras.enforce_tags=True>")
        enforce_tags(cfg, save_to_file=True)
    if cfg.extras.get("print_config"):
        log.info("Printing config tree with Rich! <cfg.extras.print_config=True>")
        print_config_tree(cfg, save_to_file=True)


def task_wrapper(task_func: Callable) -> Callable:
    """Exception logging + logger cleanup around a task (reference: util.py:58-110)."""

    @functools.wraps(task_func)
    def wrap(cfg: ConfigNode):
        object_dict: dict = {}
        try:
            metric_dict, object_dict = task_func(cfg)
        except Exception as ex:
            log.exception("Task failed")
            output_dir = cfg.select("paths.output_dir")
            if output_dir:
                with open(Path(str(output_dir)) / "exec_failure.log", "a") as f:
                    f.write(repr(ex) + "\n")
            raise
        finally:
            log.info(f"Output dir: {cfg.select('paths.output_dir')}")
            for lg in object_dict.get("logger") or []:
                try:
                    lg.finalize()
                except Exception:
                    pass
        return metric_dict, object_dict

    return wrap


def get_metric_value(metric_dict: dict, metric_name: str | None) -> float | None:
    """Retrieve the sweep objective (reference: util.py:113-132)."""
    if not metric_name:
        log.info("Metric name is None! Skipping metric value retrieval...")
        return None
    if metric_name not in metric_dict:
        raise RuntimeError(
            f"Metric value not found! <metric_name={metric_name}>\n"
            "Make sure metric name logged in LightningModule is correct!\n"
            "Make sure `optimized_metric` name in `hparams_search` config is correct!")
    value = float(metric_dict[metric_name])
    log.info(f"Retrieved metric value! <{metric_name}={value}>")
    return value

