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
``opt_state`` is optax's, which a task's ``optimizer_state_from_jax`` maps
onto its torch optimizer's state for ``fit``.

**Wire codecs** (msla_tpu/train/checkpoint.py:114-277). ``wire`` makes a
smaller file of an approximate state, for ``last.ckpt``: "bf16" writes the
weights and the optimizer's moments in bf16; "q8" the weights in bf16 and
the moments as int8 with one fp32 scale a block of 1,024 elements (max|x| /
127 a block, round half to even); "params=…,opt=…" picks each side's codec
("bf16", "q8" or "off"); "off" or "exact" pins a file exact. A tensor is
encoded only if it is floating, has 16,384 elements or more, and (for bf16)
is not bf16 already; the rest stays exact, and the frozen sidecar always
does. The encoding runs where the tensors are, on the card before the copy
to the host, so the copy and the file carry the small form. An encoded
tensor is a dict ``{"__wire__": codec, "dtype", "shape", "v"}`` (bf16) or
``{..., "q": int8 (blocks, 1024), "s": fp32 (blocks,)}`` (q8), the JAX
file's nodes; the file's ``wire`` entry names the spec. ``wire=None`` takes
the environment's ``MSLA_CKPT_WIRE``. ``load_checkpoint`` decodes the port's
wired files and the JAX package's, to the original dtype and shape.

**Background writes** (msla_tpu/train/checkpoint.py:24-76, 418-456).
``save_checkpoint(..., background=True)`` takes its snapshot before it
returns, since torch's optimizer updates the parameters and moments in
place: on the card a clone on the device (milliseconds) when the card has
room for 1.5 copies, else a copy to the host; on the CPU a copy (``.cpu()``
of a CPU tensor would be the live tensor). One writer thread then copies the
clone to the host, on a stream of its own, serializes and writes, in the
order the writes were asked for; each path has its future. A reader
(``load_checkpoint``) and a second write to a path wait for the write in
flight to it; ``wait_for_pending`` joins one path's write, or all, and a
failed write raises there once; ``link_after_pending`` queues a link behind
the write of its source. A frozen sidecar is written in the same order,
before the checkpoint that names it. Every file goes to ``<name>.tmp`` and is
renamed into place, so a crash never leaves half a file.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Mapping

import numpy as np
import torch

from msla_tpu_torch.utils import msgpack

FROZEN_SIDECAR = "frozen.ckpt"  # the JAX package's legacy name, honoured on load
ZIP_MAGIC = b"PK\x03\x04"       # torch.save's format
WIRE_KEY = "__wire__"
Q8_BLOCK = 1024
WIRE_MIN_ELEMS = 16384           # below ~64 KB the savings do not cover the overhead
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_WEIGHT_PERIOD = 9973


log = logging.getLogger(__name__)

# one ordered writer thread; the futures of each path's writes and links
_executor: ThreadPoolExecutor | None = None
_pending: dict[str, list[Future]] = {}
_lock = threading.Lock()
_streams: dict[torch.device, torch.cuda.Stream] = {}


def _path_key(path: str | Path) -> str:
    """One key for every spelling of a file's path."""
    return str(Path(path).expanduser().resolve())


def _submit(job: Callable[[], Any], *paths: str | Path) -> Future:
    """Queue ``job`` on the writer thread, as pending on each of ``paths``."""
    global _executor
    with _lock:
        if _executor is None:
            _executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-write")
        future = _executor.submit(job)
        for path in paths:
            _pending.setdefault(_path_key(path), []).append(future)
    return future


def is_pending(path: str | Path) -> bool:
    with _lock:
        return _path_key(path) in _pending


def wait_for_pending(path: str | Path | None = None) -> None:
    """Block until the background writes to ``path`` (or every one) have
    landed. A failed write raises its error here once: its future leaves the
    registry first, so a later write to the same path starts afresh. With
    several failures the first raises and the others are logged."""
    with _lock:
        if path is None:
            futures = [f for fs in _pending.values() for f in fs]
            _pending.clear()
        else:
            futures = _pending.pop(_path_key(path), [])
            for key in [k for k, fs in _pending.items() if any(f in futures for f in fs)]:
                _pending[key] = [f for f in _pending[key] if f not in futures]
                if not _pending[key]:
                    del _pending[key]
    errors = []
    for future in dict.fromkeys(futures):  # a link is pending on two paths
        try:
            future.result()
        except Exception as err:  # raised once, after the others have landed
            errors.append(err)
    for err in errors[1:]:
        log.error("background checkpoint write failed: %s", err)
    if errors:
        raise errors[0]


def _tensor_key(t: torch.Tensor) -> tuple:
    return (t.device, t.untyped_storage().data_ptr(), t.storage_offset(), tuple(t.shape),
            t.stride(), t.dtype)


def _map_tensors(tree, fn, copies: dict):
    """``tree`` with ``fn`` applied to each tensor; tensors that are one view
    of one storage (BERT's tied decoder and word embeddings) stay one tensor,
    so ``torch.save`` writes them once."""
    if isinstance(tree, torch.Tensor):
        key = _tensor_key(tree)
        if key not in copies:
            copies[key] = fn(tree)
        return copies[key]
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn, copies) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn, copies) for v in tree)
    return tree


def _to_cpu(tree):
    """The tree with its tensors copied to the CPU: a copy also of a CPU
    tensor, which ``.cpu()`` would hand back as it is, live."""
    return _map_tensors(tree, lambda t: t.detach().to("cpu", copy=True), {})


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _snapshot(tree) -> Callable[[], Any]:
    """A copy of ``tree`` taken now, and a function that gives it with its
    tensors on the CPU (run on the writer thread). On the card the copy is a
    clone on the device when the card has room for 1.5 copies: the writer
    copies it to the host on a stream of its own, after the clones are done,
    so neither the loop nor its kernels wait for the transfer. Otherwise, and
    on the CPU, the copy goes to the host now."""
    cuda = {t.device for t in _tensors(tree) if t.is_cuda}
    if len(cuda) == 1:
        device, = cuda
        need = sum(t.numel() * t.element_size() for t in _tensors(tree) if t.is_cuda)
        free, _ = torch.cuda.mem_get_info(device)
        if free > 1.5 * need:
            clone = _map_tensors(tree, lambda t: t.detach().clone(), {})
            cloned = torch.cuda.Event()
            cloned.record(torch.cuda.current_stream(device))

            def to_host():
                with _lock:
                    if device not in _streams:
                        _streams[device] = torch.cuda.Stream(device)
                    stream = _streams[device]
                with torch.cuda.stream(stream):
                    stream.wait_event(cloned)
                    host = _to_cpu(clone)
                    stream.synchronize()
                return host
            return to_host
    host = _to_cpu(tree)
    return lambda: host


def _write_file(path: Path, payload: Callable[[], Any]) -> dict:
    """``torch.save`` of ``payload()`` to ``<path>.tmp``, renamed into place;
    the writer's seconds and the file's bytes."""
    t0 = time.perf_counter()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save(payload(), tmp)
    tmp.replace(path)
    return {"path": str(path), "s": time.perf_counter() - t0, "bytes": path.stat().st_size}


def link_or_copy(src: str | Path, dst: str | Path) -> None:
    """``dst`` made a hard link of ``src`` (a copy where the file system takes
    no link)."""
    if os.path.exists(dst):
        os.remove(dst)
    try:
        os.link(src, dst)
    except OSError:
        shutil.copyfile(src, dst)


def link_after_pending(src: str | Path, dst: str | Path) -> None:
    """``link_or_copy(src, dst)``, queued behind a write to ``src`` in flight
    (the writer runs its jobs in order), so ``dst`` never names half a file;
    the queued link is pending on both paths, so ``src`` is not removed
    before it is made."""
    if is_pending(src):
        _submit(lambda: link_or_copy(src, dst), src, dst)
    else:
        wait_for_pending(dst)
        link_or_copy(src, dst)


def parse_wire(spec: str | None) -> tuple[str | None, str | None]:
    """The (weights, optimizer) codecs of a spec: "bf16" both bf16; "q8" the
    weights bf16 and the moments q8; "params=…,opt=…" each side's ("off"
    leaves a side exact); "off" and "exact" none (msla_tpu/train/checkpoint.py
    ``_parse_wire``, with its errors)."""
    if not spec:
        return None, None
    spec = spec.strip()
    aliases = {"bf16": ("bf16", "bf16"), "bfloat16": ("bf16", "bf16"), "q8": ("bf16", "q8"),
               "off": (None, None), "exact": (None, None)}
    if "=" not in spec:
        if spec not in aliases:
            raise ValueError(f"unknown checkpoint wire spec {spec!r} — use "
                             "'bf16', 'q8', or 'params=...,opt=...'")
        return aliases[spec]
    out: dict[str, str | None] = {"params": None, "opt": None}
    for part in spec.split(","):
        k, _, v = part.partition("=")
        k, v = k.strip(), v.strip()
        if k not in out or v not in ("bf16", "q8", "off"):
            raise ValueError(f"bad wire spec component {part!r}")
        out[k] = None if v == "off" else v
    return out["params"], out["opt"]


def q8_encode(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 codes (blocks, 1,024) and fp32 scales (blocks,): the flat tensor
    padded with zeros to whole blocks, scale = max|x| / 127 a block, codes
    x / scale rounded half to even (``_q8_encode_jnp``'s function)."""
    flat = x.detach().to(torch.float32).reshape(-1)
    blocks = torch.nn.functional.pad(flat, (0, (-flat.numel()) % Q8_BLOCK)).view(-1, Q8_BLOCK)
    scale = blocks.abs().amax(dim=1) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-30)[:, None]).to(torch.int8)
    return q, scale


def _encodable(t, codec: str) -> bool:
    return (isinstance(t, torch.Tensor) and t.is_floating_point()
            and t.numel() >= WIRE_MIN_ELEMS and not (codec == "bf16" and t.dtype == torch.bfloat16))


def wire_encode(tree, codec: str | None):
    """``tree`` with each encodable tensor replaced by its codec's node,
    computed on the tensor's device."""
    if codec is None:
        return tree

    def encode(t):
        meta = {WIRE_KEY: codec, "dtype": str(t.dtype).removeprefix("torch."),
                "shape": list(t.shape)}
        if codec == "bf16":
            return {**meta, "v": t.detach().to(torch.bfloat16)}
        q, s = q8_encode(t)
        return {**meta, "q": q, "s": s}

    if isinstance(tree, torch.Tensor):
        return encode(tree) if _encodable(tree, codec) else tree
    if isinstance(tree, dict):
        return {k: wire_encode(v, codec) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(wire_encode(v, codec) for v in tree)
    return tree


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def wire_decode(node):
    """A tree with each codec node decoded to a tensor of its dtype and shape
    (bf16 through fp32; q8 as codes × scale in fp32), the port's nodes and
    the JAX files' alike."""
    if isinstance(node, dict):
        if node.get(WIRE_KEY) in ("bf16", "q8"):
            dtype = getattr(torch, str(node["dtype"]))
            shape = tuple(int(d) for d in node["shape"])
            if node[WIRE_KEY] == "bf16":
                return _as_tensor(node["v"]).to(torch.float32).to(dtype).reshape(shape)
            q = _as_tensor(node["q"]).to(torch.float32)
            s = _as_tensor(node["s"]).to(torch.float32)
            n = int(np.prod(shape, dtype=np.int64))
            return (q * s[:, None]).reshape(-1)[:n].reshape(shape).to(dtype)
        return {k: wire_decode(v) for k, v in node.items()}
    if isinstance(node, list):
        return [wire_decode(v) for v in node]
    return node


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


def save_frozen_sidecar(dirpath: Path, frozen: Mapping[str, torch.Tensor],
                        background: bool = False) -> str:
    """Write ``frozen-<fingerprint>.ckpt`` unless the directory has it or it
    is being written (the name encodes the content); returns the file's
    name."""
    name = f"frozen-{frozen_fingerprint(frozen)}.ckpt"
    sidecar = Path(dirpath) / name
    if not sidecar.exists() and not is_pending(sidecar):
        if background:
            tensors = _snapshot(dict(frozen))
            _submit(lambda: _write_file(sidecar, lambda: {"state_dict": tensors()}), sidecar)
        else:
            _write_file(sidecar, lambda: {"state_dict": _to_cpu(dict(frozen))})
    return name


def save_checkpoint(path: str | Path, *, state_dict: Mapping[str, torch.Tensor],
                    opt_state: dict | None = None, epoch: int = 0, global_step: int = 0,
                    hparams: dict | None = None, callback_metrics: dict | None = None,
                    callbacks_state: list | None = None,
                    generator_state: torch.Tensor | None = None,
                    frozen_keys: tuple = (), background: bool = False,
                    wire: str | None = None) -> Future | None:
    """Write one checkpoint atomically: a crash never leaves half a file.
    ``frozen_keys``' parts go to the directory's sidecar. ``wire`` encodes
    the rest (``parse_wire``; None takes ``MSLA_CKPT_WIRE``). With
    ``background`` the tensors are copied (``_snapshot``) before this
    returns and the writer thread writes them; the future it returns gives
    the writer's seconds and the file's bytes. Without, the write is done
    when it returns (None). A write in flight to ``path`` is joined first."""
    path = Path(path)
    wait_for_pending(path)
    if wire is None:
        wire = os.environ.get("MSLA_CKPT_WIRE") or None
    wire_params, wire_opt = parse_wire(wire)
    state_dict = dict(state_dict)
    frozen_keys = tuple(k for k in frozen_keys if any(is_frozen(s, (k,)) for s in state_dict))
    meta: dict[str, Any] = {}
    if frozen_keys:
        frozen = {k: v for k, v in state_dict.items() if is_frozen(k, frozen_keys)}
        state_dict = {k: v for k, v in state_dict.items() if not is_frozen(k, frozen_keys)}
        meta["frozen_file"] = save_frozen_sidecar(path.parent, frozen, background)
        meta["frozen_keys"] = json.dumps(list(frozen_keys))
    if wire_params or wire_opt:  # after the frozen split: the sidecar stays exact
        meta["wire"] = wire
        state_dict = wire_encode(state_dict, wire_params)
        opt_state = wire_encode(opt_state, wire_opt)
    tensors = {"state_dict": state_dict, "opt_state": opt_state if opt_state is not None else {}}
    if generator_state is not None:
        tensors["generator"] = generator_state
    tensors = _snapshot(tensors) if background else _to_cpu(tensors)
    scalars: dict[str, Any] = {
        "epoch": int(epoch),
        "global_step": int(global_step),
        "hparams": json.dumps(hparams or {}, default=str),
        "callback_metrics": {k: float(v) for k, v in (callback_metrics or {}).items()},
        "callbacks": json.dumps(callbacks_state or [], default=str),
        **meta,
    }
    if not background:
        _write_file(path, lambda: {**tensors, **scalars})
        return None
    return _submit(lambda: _write_file(path, lambda: {**tensors(), **scalars}), path)


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
    on the CPU, wired tensors decoded, ``hparams`` and ``callbacks`` decoded
    from JSON, the frozen sidecar's parts put back into ``state_dict``."""
    path = Path(path)
    wait_for_pending(path)  # a background write in flight to it
    payload = _read(path)
    if payload.pop("wire", None):
        payload["state_dict"] = wire_decode(payload["state_dict"])
        payload["opt_state"] = wire_decode(payload.get("opt_state") or {})
    payload["hparams"] = json.loads(payload.get("hparams") or "{}")
    payload["callbacks"] = json.loads(payload.get("callbacks") or "[]")
    frozen_file = payload.pop("frozen_file", None)
    keys = json.loads(payload.pop("frozen_keys", None) or "[]")
    if frozen_file:
        sidecar = path.parent / str(frozen_file)
        wait_for_pending(sidecar)
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
