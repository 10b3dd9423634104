"""Single-file checkpoints (.ckpt), the port of msla_tpu/train/checkpoint.py:280-490.

A checkpoint is one file written with ``torch.save``, a dict with the JAX
payload's keys (msla_tpu/train/checkpoint.py:376-410):

  state_dict        the network's state_dict, under the reference torch
                    model's key names (``nn/vqvae_net.py``)
  opt_state         the optimizer's ``state_dict()``, or {} for a
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

**Frozen sidecars.** ``frozen_keys`` names top-level parts of the state that
never change during training (Audio-BERT's ``bert`` and ``codebook``: the
argmax detaches BERT and the codebook is a buffer). Their tensors go to one
``frozen-<fingerprint>.ckpt`` beside the checkpoint, written once per content
and directory, and the checkpoint keeps the rest with ``frozen_file`` and
``frozen_keys``. The fingerprint hashes the names, shapes and dtypes and two
exact integer sums of each tensor's bits (one weighted by position), computed
where the tensors live, so only the fingerprint leaves the card; a changed
frozen tensor gets a new name, so no checkpoint of an earlier run in the
directory is reassembled from content that is not its own (JAX's reason,
msla_tpu/train/checkpoint.py:282-290). ``load_checkpoint`` reassembles them.

**JAX files.** ``load_checkpoint`` also reads the JAX package's msgpack
``.ckpt`` (and its sidecar), told apart by its first bytes, through the
port's own decoder (``utils/msgpack.py``). Its ``state_dict`` stays the flax
tree, with ``format: "jax"`` in the payload: a task's
``state_dict_from_jax`` maps it to the port's names (``weights_of``). Its
``opt_state`` is optax's, which the port's optimizers do not read. A file
written with the ``wire`` codecs raises.

Waiting (ROADMAP.md queue item 2): background writes and the ``wire`` codecs.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Any, Mapping

import torch

from msla_tpu_torch.utils import msgpack

FROZEN_SIDECAR = "frozen.ckpt"  # the JAX package's legacy name, honoured on load
ZIP_MAGIC = b"PK\x03\x04"       # torch.save's format
_WIRE = "ROADMAP.md queue item 2 (the rest of the trainer: the wire codecs)"
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_WEIGHT_PERIOD = 9973


def _to_cpu(tree, copies: dict | None = None):
    """The tree with its tensors on the CPU. Tensors that are one view of one
    storage (BERT's tied decoder and word embeddings) stay one tensor, so
    ``torch.save`` writes them once."""
    copies = {} if copies is None else copies
    if isinstance(tree, torch.Tensor):
        key = (tree.device, tree.untyped_storage().data_ptr(), tree.storage_offset(),
               tuple(tree.shape), tree.stride(), tree.dtype)
        if key not in copies:
            copies[key] = tree.detach().cpu()
        return copies[key]
    if isinstance(tree, dict):
        return {k: _to_cpu(v, copies) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v, copies) for v in tree)
    return tree


def is_frozen(key: str, frozen_keys) -> bool:
    """Whether a state_dict key lies in one of the named top-level parts."""
    return any(key == k or key.startswith(k + ".") for k in frozen_keys)


def frozen_fingerprint(frozen: Mapping[str, torch.Tensor]) -> str:
    """Ten hex digits of a hash of the names, shapes and dtypes, and of two
    sums of each tensor's bits as int64 (plain, and weighted by position
    modulo 9,973): exact integer arithmetic, so the same content gives the
    same name on any device and in any order of summation, and any changed
    element changes the plain sum. The sums run where the tensors are; one
    transfer brings them to the host."""
    h = hashlib.sha1()
    sums = []
    for name, t in frozen.items():
        h.update(f"{name}:{tuple(t.shape)}:{t.dtype};".encode())
        bits = t.detach().contiguous().reshape(-1).view(_BITS[t.element_size()]).to(torch.int64)
        weight = torch.arange(bits.numel(), device=bits.device) % _WEIGHT_PERIOD + 1
        sums.append(torch.stack([bits.sum(), (bits * weight).sum()]))
    if sums:
        h.update(torch.stack(sums).cpu().numpy().tobytes())
    return h.hexdigest()[:10]


def save_frozen_sidecar(dirpath: Path, frozen: Mapping[str, torch.Tensor]) -> str:
    """Write ``frozen-<fingerprint>.ckpt`` unless the directory has it (the
    name encodes the content); returns the file's name."""
    name = f"frozen-{frozen_fingerprint(frozen)}.ckpt"
    sidecar = dirpath / name
    if not sidecar.exists():
        dirpath.mkdir(parents=True, exist_ok=True)
        tmp = sidecar.with_suffix(".ckpt.tmp")
        torch.save({"state_dict": _to_cpu(dict(frozen))}, tmp)
        tmp.replace(sidecar)
    return name


def save_checkpoint(path: str | Path, *, state_dict: Mapping[str, torch.Tensor],
                    opt_state: dict | None = None, epoch: int = 0, global_step: int = 0,
                    hparams: dict | None = None, callback_metrics: dict | None = None,
                    callbacks_state: list | None = None,
                    generator_state: torch.Tensor | None = None,
                    frozen_keys: tuple = ()) -> None:
    """Write one checkpoint atomically: a crash never leaves half a file.
    ``frozen_keys``' parts go to the directory's sidecar."""
    path = Path(path)
    state_dict = dict(state_dict)
    frozen_keys = tuple(k for k in frozen_keys if any(is_frozen(s, (k,)) for s in state_dict))
    meta: dict[str, Any] = {}
    if frozen_keys:
        frozen = {k: v for k, v in state_dict.items() if is_frozen(k, frozen_keys)}
        state_dict = {k: v for k, v in state_dict.items() if not is_frozen(k, frozen_keys)}
        meta["frozen_file"] = save_frozen_sidecar(path.parent, frozen)
        meta["frozen_keys"] = json.dumps(list(frozen_keys))
    payload: dict[str, Any] = {
        "state_dict": _to_cpu(state_dict),
        "opt_state": _to_cpu(opt_state) if opt_state is not None else {},
        "epoch": int(epoch),
        "global_step": int(global_step),
        "hparams": json.dumps(hparams or {}, default=str),
        "callback_metrics": {k: float(v) for k, v in (callback_metrics or {}).items()},
        "callbacks": json.dumps(callbacks_state or [], default=str),
        **meta,
    }
    if generator_state is not None:
        payload["generator"] = generator_state.cpu()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save(payload, tmp)
    tmp.replace(path)


def is_jax_file(path: str | Path) -> bool:
    """A JAX msgpack checkpoint (a map), not a ``torch.save`` zip."""
    with open(path, "rb") as f:
        head = f.read(4)
    return head != ZIP_MAGIC and msgpack.is_msgpack_map(head)


def _read(path: Path) -> dict:
    if is_jax_file(path):
        payload = msgpack.read(path)
        payload["format"] = "jax"
        return payload
    return torch.load(path, map_location="cpu", weights_only=True)


def load_checkpoint(path: str | Path) -> dict:
    """The payload of ``save_checkpoint`` (or of the JAX package's), tensors
    on the CPU, ``hparams`` and ``callbacks`` decoded from JSON, the frozen
    sidecar's parts put back into ``state_dict``."""
    path = Path(path)
    payload = _read(path)
    if payload.get("wire"):
        raise NotImplementedError(f"{path} was written with wire={payload['wire']!r}: "
                                  f"reading it is {_WIRE}")
    payload["hparams"] = json.loads(payload.get("hparams") or "{}")
    payload["callbacks"] = json.loads(payload.get("callbacks") or "[]")
    frozen_file = payload.pop("frozen_file", None)
    keys = json.loads(payload.pop("frozen_keys", None) or "[]")
    if frozen_file:
        sidecar = path.parent / str(frozen_file)
        if not sidecar.exists():
            raise FileNotFoundError(
                f"checkpoint {path} references frozen sidecar {sidecar} which is missing — "
                f"copy checkpoints with their directory's {frozen_file} sidecar")
        frozen = _read(sidecar)["state_dict"]
        if payload.get("format") == "jax":  # flax trees: the named subtrees
            payload["state_dict"].update({k: frozen[k] for k in keys})
        else:
            payload["state_dict"].update({k: v for k, v in frozen.items() if is_frozen(k, keys)})
    return payload


def weights_of(task, payload: Mapping) -> dict[str, torch.Tensor]:
    """The payload's weights as ``task.net``'s state_dict: a JAX file's flax
    tree through the task's ``state_dict_from_jax``."""
    if payload.get("format") == "jax":
        return task.state_dict_from_jax(payload["state_dict"])
    return payload["state_dict"]


def restore_params(path: str | Path, task=None):
    """A checkpoint's weights (msla_tpu/train/checkpoint.py ``restore_params``):
    the state_dict, or with ``task`` its net's state_dict, a JAX file's
    mapped through the task."""
    payload = load_checkpoint(path)
    return payload["state_dict"] if task is None else weights_of(task, payload)
