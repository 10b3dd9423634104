"""Hydra-style config composition (the port's copy of msla_tpu/config/compose.py).

Implements the subset of Hydra 1.3 semantics the reference config tree uses
(reference: configs/train.yaml:5-28):

* a ``defaults`` list with ``_self_`` ordering,
* config groups packaged under their group key,
* ``# @package _global_`` file directives (reference: configs/debug/default.yaml:1),
* ``optional`` group entries and ``null`` group selections,
* ``override group/sub: name`` entries (reference: configs/hparams_search/optuna.yaml:5-6),
* CLI overrides: ``key=value`` dotted assignments, ``group=option`` reselection,
  ``+key=value`` additions and ``~key`` deletions.
"""
from __future__ import annotations

import copy
import re
from pathlib import Path
from typing import Any

import yaml

from msla_tpu_torch.config.node import ConfigNode

_PACKAGE_RE = re.compile(r"^#\s*@package\s+(\S+)\s*$", re.MULTILINE)


class _ConfigLoader(yaml.SafeLoader):
    """SafeLoader with YAML 1.2-style float parsing ('2e-4' is a float)."""


_ConfigLoader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
         |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
         |\.[0-9_]+(?:[eE][-+][0-9]+)?
         |[-+]?\.(?:inf|Inf|INF)
         |\.(?:nan|NaN|NAN))$""",
        re.X,
    ),
    list("-+0123456789."),
)


def _yaml_load(text: str) -> Any:
    return yaml.load(text, Loader=_ConfigLoader)


class ComposeError(RuntimeError):
    pass


def _deep_merge(dst: dict, src: dict) -> dict:
    """Merge src into dst in place; src wins, dicts merge recursively."""
    for key, value in src.items():
        if isinstance(value, dict) and isinstance(dst.get(key), dict):
            _deep_merge(dst[key], value)
        else:
            dst[key] = copy.deepcopy(value)
    return dst


def _load_yaml(path: Path) -> tuple[dict, str | None]:
    text = path.read_text()
    m = _PACKAGE_RE.search(text)
    package = m.group(1) if m else None
    data = _yaml_load(text)
    if data is None:
        data = {}
    if not isinstance(data, dict):
        raise ComposeError(f"Config file {path} must contain a mapping, got {type(data).__name__}")
    return data, package


def _package_tree(body: dict, package: str | None, group: str | None) -> dict:
    """Nest the body under its package path (default: the group path)."""
    if package == "_global_":
        return body
    target = package if package is not None else group
    if not target:
        return body
    for part in reversed(target.replace("/", ".").split(".")):
        body = {part: body}
    return body


class _Composer:
    def __init__(self, config_dir: Path):
        self.config_dir = Path(config_dir)

    def group_exists(self, group: str) -> bool:
        return (self.config_dir / group).is_dir()

    def option_path(self, group: str | None, name: str) -> Path:
        base = self.config_dir / group if group else self.config_dir
        return base / f"{name}.yaml"

    def compose_file(self, group: str | None, name: str, result: dict,
                     group_overrides: dict[str, Any]) -> None:
        """Process one config file (defaults first, body at its _self_ slot)."""
        path = self.option_path(group, name)
        if not path.is_file():
            raise ComposeError(f"Config file not found: {path}")
        body, package = _load_yaml(path)
        defaults = body.pop("defaults", None)

        packaged_body = _package_tree(body, package, group)
        if defaults is None:
            _deep_merge(result, packaged_body)
            return

        if not any(entry == "_self_" for entry in defaults):
            defaults = list(defaults) + ["_self_"]

        for entry in defaults:
            if entry == "_self_":
                _deep_merge(result, packaged_body)
                continue
            self._process_default_entry(entry, group, result, group_overrides)

    def _process_default_entry(self, entry: Any, parent_group: str | None, result: dict,
                               group_overrides: dict[str, Any]) -> None:
        optional = False
        if isinstance(entry, str):
            # bare entry: sibling file in the same group
            self.compose_file(parent_group, entry, result, group_overrides)
            return
        if not isinstance(entry, dict) or len(entry) != 1:
            raise ComposeError(f"Malformed defaults entry: {entry!r}")
        (key, selection), = entry.items()

        if key.startswith("override "):
            key = key[len("override "):].strip()
        if key.startswith("optional "):
            optional = True
            key = key[len("optional "):].strip()

        if key.startswith("/"):  # absolute group path (e.g. "override /hydra/sweeper")
            group = key[1:]
        else:
            group = key if parent_group is None else f"{parent_group}/{key}"
        # CLI reselection of this group wins over the file's default
        if group in group_overrides:
            selection = group_overrides.pop(group)
        if selection is None:
            return
        path = self.option_path(group, selection)
        if not path.is_file():
            if optional:
                return
            raise ComposeError(f"Config group '{group}' has no option '{selection}' ({path})")
        self.compose_file(group, selection, result, group_overrides)


def _parse_value(text: str) -> Any:
    try:
        return _yaml_load(text)
    except yaml.YAMLError:
        return text


def split_overrides(config_dir: str | Path, overrides: list[str]) -> tuple[dict, list, list, list]:
    """Split CLI overrides into group selections, value sets, adds, deletions."""
    config_dir = Path(config_dir)
    groups: dict[str, Any] = {}
    sets: list[tuple[str, Any]] = []
    adds: list[tuple[str, Any]] = []
    dels: list[str] = []
    for ov in overrides:
        if ov.startswith("~"):
            dels.append(ov[1:].split("=", 1)[0])
            continue
        add = ov.startswith("+")
        if add:
            ov = ov[1:]
        if "=" not in ov:
            raise ComposeError(f"Override '{ov}' must look like key=value")
        key, _, value = ov.partition("=")
        key = key.strip()
        group_path = key.replace(".", "/")
        if (config_dir / group_path).is_dir():
            groups[group_path] = None if value in ("null", "None", "") else value
        elif add:
            adds.append((key, _parse_value(value)))
        else:
            sets.append((key, _parse_value(value)))
    return groups, sets, adds, dels


def compose(config_dir: str | Path, config_name: str = "train",
            overrides: list[str] | None = None) -> ConfigNode:
    """Compose the full config, mirroring ``@hydra.main`` (reference: src/main.py:214)."""
    config_dir = Path(config_dir)
    composer = _Composer(config_dir)
    groups, sets, adds, dels = split_overrides(config_dir, list(overrides or []))

    result: dict = {}
    composer.compose_file(None, config_name, result, groups)

    # group overrides that never matched a defaults entry are appended
    for group, selection in groups.items():
        if selection is None:
            continue
        composer.compose_file(group, selection, result, {})

    cfg = ConfigNode(result)
    for key, value in sets + adds:
        cfg.update_dotted(key, value)
    for key in dels:
        cfg.delete_dotted(key)
    return cfg
