"""Config tree with lazy ``${...}`` interpolation (the port's copy of
msla_tpu/config/node.py).

Native replacement for OmegaConf's DictConfig used by the reference's Hydra
config surface (reference: configs/train.yaml, src/main.py:214-236). The whole
config is stored as one raw tree of dicts/lists/scalars; ``ConfigNode`` wraps a
path into that tree and resolves interpolations at access time so that values
set late (e.g. ``hydra.runtime.output_dir``) are visible to earlier templates.
"""
from __future__ import annotations

import os
import re
from datetime import datetime
from typing import Any, Iterator

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")

MISSING = "???"


class InterpolationError(Exception):
    """Raised for unresolvable/cyclic ${...} references.

    Deliberately NOT a KeyError: a broken interpolation must surface as
    itself, not be swallowed into a 'key not found' AttributeError.
    """


class ConfigNode:
    """Attribute/key access view over a shared raw config tree."""

    __slots__ = ("_root", "_path", "_now")

    def __init__(self, tree: Any, _root: Any = None, _path: tuple = (), _now: datetime | None = None):
        object.__setattr__(self, "_root", tree if _root is None else _root)
        object.__setattr__(self, "_path", _path)
        object.__setattr__(self, "_now", _now or datetime.now())
        if _root is None and _path == ():
            pass

    # ---- raw access -------------------------------------------------------
    def _raw(self) -> Any:
        node = self._root
        for key in self._path:
            node = node[key]
        return node

    def _wrap(self, value: Any, path: tuple) -> Any:
        if isinstance(value, dict):
            return ConfigNode(None, _root=self._root, _path=path, _now=self._now)
        if isinstance(value, list):
            return [self._wrap(v, path + (i,)) for i, v in enumerate(value)]
        if isinstance(value, str):
            return self._resolve_str(value, set())
        return value

    # ---- interpolation ----------------------------------------------------
    def _lookup(self, dotted: str, seen: frozenset | set) -> Any:
        node = self._root
        for part in dotted.split("."):
            if isinstance(node, list):
                node = node[int(part)]
            elif isinstance(node, dict) and part in node:
                node = node[part]
            else:
                raise InterpolationError(f"Interpolation key '{dotted}' not found")
        if isinstance(node, str):
            return self._resolve_str(node, seen)
        if isinstance(node, dict):
            return ConfigNode(None, _root=self._root, _path=tuple(dotted.split(".")), _now=self._now)
        return node

    def _resolve_expr(self, expr: str, seen: set) -> Any:
        expr = expr.strip()
        if expr in seen:
            raise InterpolationError(f"Interpolation cycle at '{expr}'")
        seen = set(seen) | {expr}
        if ":" in expr:
            resolver, _, arg = expr.partition(":")
            resolver = resolver.strip()
            if resolver == "oc.env":
                parts = [p.strip() for p in arg.split(",", 1)]
                val = os.environ.get(parts[0])
                if val is None:
                    if len(parts) == 2:
                        return parts[1]
                    raise InterpolationError(f"Environment variable '{parts[0]}' not set")
                return val
            if resolver == "now":
                return self._now.strftime(arg)
            if resolver == "hydra":
                return self._lookup("hydra." + arg.strip().replace("/", "."), seen)
            raise InterpolationError(f"Unknown resolver '{resolver}'")
        return self._lookup(expr, seen)

    def _resolve_str(self, s: str, seen: set) -> Any:
        m = _INTERP_RE.fullmatch(s)
        if m:  # whole-string interpolation keeps original type
            return self._resolve_expr(m.group(1), seen)

        def sub(match: re.Match) -> str:
            return str(self._resolve_expr(match.group(1), seen))

        prev = None
        while prev != s and "${" in s:
            prev = s
            s = _INTERP_RE.sub(sub, s)
        return s

    # ---- mapping protocol -------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        raw = self._raw()
        if key not in raw:
            raise KeyError(key)
        return self._wrap(raw[key], self._path + (key,))

    def __getattr__(self, key: str) -> Any:
        if key in ConfigNode.__slots__ or key.startswith("__"):
            raise AttributeError(key)
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(f"Config key '{key}' not found at {'.'.join(map(str, self._path)) or '<root>'}") from e

    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, ConfigNode):
            value = value.to_container(resolve=False)
        self._raw()[key] = value

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __delitem__(self, key: str) -> None:
        del self._raw()[key]

    def __contains__(self, key: str) -> bool:
        return key in self._raw()

    def __iter__(self) -> Iterator[str]:
        return iter(self._raw())

    def __len__(self) -> int:
        return len(self._raw())

    def __bool__(self) -> bool:
        return bool(self._raw())

    def get(self, key: str, default: Any = None) -> Any:
        try:
            val = self[key]
        except KeyError:
            return default
        return default if val is None else val

    def keys(self):
        return self._raw().keys()

    def items(self):
        for k in self._raw():
            yield k, self[k]

    def values(self):
        for k in self._raw():
            yield self[k]

    def setdefault(self, key: str, value: Any) -> Any:
        if key not in self:
            self[key] = value
        return self[key]

    # ---- utilities --------------------------------------------------------
    def select(self, dotted: str, default: Any = None) -> Any:
        """Look up a dotted path, returning ``default`` when missing."""
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, ConfigNode) or part not in node:
                return default
            node = node[part]
        return node

    def update_dotted(self, dotted: str, value: Any) -> None:
        """Set a (possibly new) dotted path in the raw tree."""
        raw = self._raw()
        parts = dotted.split(".")
        for part in parts[:-1]:
            if part not in raw or not isinstance(raw[part], dict):
                raw[part] = {}
            raw = raw[part]
        raw[parts[-1]] = value

    def delete_dotted(self, dotted: str) -> None:
        raw = self._raw()
        parts = dotted.split(".")
        for part in parts[:-1]:
            raw = raw[part]
        raw.pop(parts[-1], None)

    def to_container(self, resolve: bool = True) -> Any:
        """Materialize to plain dicts/lists, optionally resolving interpolations."""

        def conv(value: Any, path: tuple) -> Any:
            if isinstance(value, dict):
                return {k: conv(v, path + (k,)) for k, v in value.items()}
            if isinstance(value, list):
                return [conv(v, path + (i,)) for i, v in enumerate(value)]
            if resolve and isinstance(value, str):
                try:
                    out = self._resolve_str(value, set())
                except InterpolationError:
                    return value
                if isinstance(out, ConfigNode):
                    return out.to_container(resolve=resolve)
                return out
            return value

        return conv(self._raw(), self._path)

    def __repr__(self) -> str:
        return f"ConfigNode({self._raw()!r})"
