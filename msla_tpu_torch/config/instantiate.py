"""``_target_``-driven object instantiation (the port's copy of
msla_tpu/config/instantiate.py).

Replaces ``hydra.utils.instantiate`` as the reference uses it (reference:
src/main.py:29-37, src/utils/instantiators.py:11-50): recursive instantiation
of nested ``_target_`` mappings, ``_partial_``, and keyword overrides.

configs/ names the JAX package's classes. Every target that starts with
``msla_tpu.`` is mapped to ``msla_tpu_torch.`` before anything is imported,
always, and a target that would still import JAX or the JAX package
raises.
"""
from __future__ import annotations

import functools
import importlib
from typing import Any

from msla_tpu_torch.config.node import ConfigNode


class InstantiationError(RuntimeError):
    pass


_FOREIGN = ("msla_tpu", "jax", "jaxlib", "flax", "optax")


def retarget(path: str) -> str:
    """A configs/ target as the port names it: ``msla_tpu.x`` → ``msla_tpu_torch.x``."""
    return "msla_tpu_torch." + path[len("msla_tpu."):] if path.startswith("msla_tpu.") else path


def get_class(path: str) -> Any:
    path = retarget(path)
    if path.split(".")[0] in _FOREIGN:
        raise InstantiationError(f"'{path}' would import JAX or the JAX package")
    module_name, _, attr = path.rpartition(".")
    if not module_name:
        raise InstantiationError(f"Cannot import '{path}': not a dotted path")
    try:
        module = importlib.import_module(module_name)
    except ImportError as e:
        raise InstantiationError(f"Cannot import module '{module_name}' for target '{path}'") from e
    try:
        return getattr(module, attr)
    except AttributeError as e:
        raise InstantiationError(f"Module '{module_name}' has no attribute '{attr}'") from e


def _materialize(value: Any) -> Any:
    if isinstance(value, ConfigNode):
        return instantiate(value)
    if isinstance(value, dict):
        if "_target_" in value:
            return instantiate(value)
        return {k: _materialize(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_materialize(v) for v in value]
    return value


def instantiate(config: Any, **overrides: Any) -> Any:
    """Build the object described by a config node.

    A mapping with ``_target_`` becomes ``Target(**kwargs)``; nested mappings
    with ``_target_`` are instantiated first. ``_partial_: true`` returns a
    ``functools.partial`` instead of calling the target.
    """
    if config is None:
        return None
    if isinstance(config, ConfigNode):
        config = config.to_container(resolve=True)
    if not isinstance(config, dict):
        return config
    if "_target_" not in config:
        merged = {**config, **overrides}
        return {k: _materialize(v) for k, v in merged.items()}

    config = dict(config)
    target = config.pop("_target_")
    partial = bool(config.pop("_partial_", False))
    config.pop("_recursive_", None)
    config.pop("_convert_", None)

    kwargs = {k: _materialize(v) for k, v in config.items()}
    kwargs.update(overrides)

    cls = get_class(target)
    if partial:
        return functools.partial(cls, **kwargs)
    try:
        return cls(**kwargs)
    except TypeError as e:
        raise InstantiationError(f"Error instantiating '{target}': {e}") from e
