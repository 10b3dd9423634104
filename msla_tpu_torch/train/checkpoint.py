"""Single-file checkpoints (.ckpt), the port of msla_tpu/train/checkpoint.py:359-490.

A checkpoint is one file written with ``torch.save``, a dict with the JAX
payload's keys (msla_tpu/train/checkpoint.py:376-410):

  state_dict        the network's state_dict, under the reference torch
                    model's key names (``nn/vqvae_net.py``)
  opt_state         ``torch.optim.Adam``'s ``state_dict()``, or {} for a
                    weights-only checkpoint
  epoch             completed epochs
  global_step       completed train steps
  hparams           the task's constructor keywords, as JSON
  callback_metrics  the Trainer's metrics as floats
  callbacks         each callback's class name and state, as JSON

and ``generator``: the state of the Trainer's torch.Generator of the per-step
random draws (the JAX Trainer folds its draws from the step count and needs
none). This is the reference Lightning repo's own file format, which the JAX
package mirrors in msgpack; ``torch.load(path, weights_only=True)`` reads it.
Tensors are stored on the CPU, so a checkpoint loads on any device.

Waiting (ROADMAP.md queue item 2): background writes, the ``wire`` codecs,
frozen sidecars, and reading a JAX msgpack checkpoint.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Mapping

import torch


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(path: str | Path, *, state_dict: Mapping[str, torch.Tensor],
                    opt_state: dict | None = None, epoch: int = 0, global_step: int = 0,
                    hparams: dict | None = None, callback_metrics: dict | None = None,
                    callbacks_state: list | None = None,
                    generator_state: torch.Tensor | None = None) -> None:
    """Write one checkpoint atomically: a crash never leaves half a file."""
    payload: dict[str, Any] = {
        "state_dict": _to_cpu(dict(state_dict)),
        "opt_state": _to_cpu(opt_state) if opt_state is not None else {},
        "epoch": int(epoch),
        "global_step": int(global_step),
        "hparams": json.dumps(hparams or {}, default=str),
        "callback_metrics": {k: float(v) for k, v in (callback_metrics or {}).items()},
        "callbacks": json.dumps(callbacks_state or [], default=str),
    }
    if generator_state is not None:
        payload["generator"] = generator_state.cpu()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save(payload, tmp)
    tmp.replace(path)


def load_checkpoint(path: str | Path) -> dict:
    """The payload of ``save_checkpoint``, tensors on the CPU, ``hparams`` and
    ``callbacks`` decoded from JSON."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    payload["hparams"] = json.loads(payload.get("hparams") or "{}")
    payload["callbacks"] = json.loads(payload.get("callbacks") or "[]")
    return payload
