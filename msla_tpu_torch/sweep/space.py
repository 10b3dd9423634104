"""Search-space grammar (the port's copy of msla_tpu/sweep/space.py; the
hydra-optuna-sweeper override syntax).

Parses the sweep params of configs/hparams_search/*.yaml: ``interval(a, b)``
→ continuous uniform, ``choice(a, b, c)`` → categorical, ``range(a, b[,
step])`` → discrete uniform. Draws come from a numpy ``Generator`` in the
JAX package's order, so one seed gives the same trials.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Uniform:
    low: float
    high: float
    integer: bool = False

    def sample(self, rng: np.random.Generator):
        value = rng.uniform(self.low, self.high)
        return int(round(value)) if self.integer else float(value)


@dataclass
class Categorical:
    choices: list = field(default_factory=list)

    def sample(self, rng: np.random.Generator):
        return self.choices[int(rng.integers(0, len(self.choices)))]


_FUNC_RE = re.compile(r"^\s*(interval|choice|range)\s*\((.*)\)\s*$")


def _parse_scalar(token: str):
    token = token.strip()
    try:
        value = float(token)
    except ValueError:
        return token.strip("'\"")
    plain_int = value.is_integer() and "." not in token and "e" not in token.lower()
    return int(value) if plain_int else value


def parse_distribution(spec) -> Uniform | Categorical:
    if isinstance(spec, (list, tuple)):
        return Categorical(list(spec))
    if not isinstance(spec, str):
        return Categorical([spec])
    m = _FUNC_RE.match(spec)
    if not m:
        return Categorical([_parse_scalar(spec)])
    func, args = m.group(1), [_parse_scalar(a) for a in m.group(2).split(",") if a.strip()]
    if func == "interval":
        return Uniform(float(args[0]), float(args[1]))
    if func == "range":
        step = args[2] if len(args) > 2 else 1
        return Categorical(list(np.arange(args[0], args[1], step).tolist()))
    return Categorical(args)


def parse_space(params: dict) -> dict:
    return {name: parse_distribution(spec) for name, spec in params.items()}
