"""A msgpack decoder for the files the JAX package writes (flax's
``serialization.msgpack_serialize``): its checkpoints (``.ckpt``), their frozen
sidecars and converted BERT weights (``tools/convert_hf_bert.py``).

The port reads them without the ``msgpack`` or ``flax`` packages. Decoded as
flax's ``msgpack_restore`` decodes them:

* maps → dict, arrays → list, str → str, bin → bytes, nil/bool/int/float as
  Python's;
* ext type 1 (ndarray) → a numpy array, ext 3 (npscalar) → a numpy scalar,
  ext 2 (native_complex) → complex; each ndarray is a msgpack
  ``(shape, dtype name, bytes)`` triple;
* ``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}`` dicts
  (flax's split of arrays over 1 GiB) → one array;
* ``bfloat16`` arrays, which numpy has no dtype for → ``torch.bfloat16``
  tensors (the bytes read as uint16 and viewed).

Array leaves are built with ``np.frombuffer`` over the file's buffer, with no
work per element in Python; they are views of that buffer (bf16 leaves are
copies).
"""
from __future__ import annotations

import struct
from pathlib import Path
from typing import Any

import numpy as np
import torch

EXT_NDARRAY, EXT_NATIVE_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"

# first byte → (struct format of the fixed-width value, its size)
_FIXED = {0xca: (">f", 4), 0xcb: (">d", 8),
          0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
          0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8)}
_LENGTH = {1: ">B", 2: ">H", 4: ">I"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def is_msgpack_map(head: bytes) -> bool:
    """Whether a file starting with ``head`` is a msgpack map of at least one
    entry (a fixmap of 1-15 entries, a map16 or a map32): what flax writes for
    a dict. A ``torch.save`` zip starts ``PK\\x03\\x04``, a pickle 0x80."""
    return bool(head) and (0x81 <= head[0] <= 0x8f or head[0] in (0xde, 0xdf))


class _Reader:
    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"msgpack: truncated at byte {self.pos} (wants {n} more)")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def length(self, nbytes: int) -> int:
        return self.unpack(_LENGTH[nbytes], nbytes)

    def value(self) -> Any:
        b = self.unpack(">B", 1)
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in (0xc4, 0xc5, 0xc6):       # bin 8/16/32
            return self.take(self.length(1 << (b - 0xc4)))
        if b in (0xc7, 0xc8, 0xc9):       # ext 8/16/32
            n = self.length(1 << (b - 0xc7))
            return self.ext(self.unpack(">b", 1), self.take(n))
        if b in _FIXED:
            fmt, n = _FIXED[b]
            return self.unpack(fmt, n)
        if b in _FIXEXT:
            code = self.unpack(">b", 1)
            return self.ext(code, self.take(_FIXEXT[b]))
        if b in (0xd9, 0xda, 0xdb):       # str 8/16/32
            return str(self.take(self.length(1 << (b - 0xd9))), "utf-8")
        if b in (0xdc, 0xdd):             # array 16/32
            return [self.value() for _ in range(self.length(2 if b == 0xdc else 4))]
        if b in (0xde, 0xdf):             # map 16/32
            return self.map(self.length(2 if b == 0xde else 4))
        raise ValueError(f"msgpack: byte 0x{b:02x} at {self.pos - 1} starts no value")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[bytes(key) if isinstance(key, memoryview) else key] = self.value()
        return out

    def ext(self, code: int, data: memoryview):
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            inner = _Reader(data)
            shape, name, raw = inner.value()
            name = str(name, "ascii") if isinstance(name, memoryview) else name
            arr = _array(raw, name, tuple(shape))
            return arr[()] if code == EXT_NPSCALAR and isinstance(arr, np.ndarray) else arr
        if code == EXT_NATIVE_COMPLEX:
            real, imag = _Reader(data).value()
            return complex(real, imag)
        raise ValueError(f"msgpack: unknown ext type {code}")


def _array(raw: memoryview, dtype_name: str, shape: tuple) -> np.ndarray | torch.Tensor:
    if dtype_name == "bfloat16":
        bits = np.frombuffer(raw, dtype=np.uint16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape)


def _finish(node):
    """bin leaves to bytes; chunked arrays joined (flax's ``_unchunk``)."""
    if isinstance(node, memoryview):
        return bytes(node)
    if isinstance(node, list):
        return [_finish(v) for v in node]
    if not isinstance(node, dict):
        return node
    if CHUNKED in node:
        shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _finish(v) for k, v in node.items()}


def unpackb(data) -> Any:
    """Decode one msgpack value from a bytes-like object. Array leaves are
    views of ``data``, which should therefore be writable (a bytearray) if
    they are to be written to."""
    reader = _Reader(memoryview(data).cast("B"))
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} bytes after the value")
    return _finish(out)


def read(path: str | Path) -> Any:
    """Decode a msgpack file, read into one writable buffer."""
    path = Path(path)
    buf = bytearray(path.stat().st_size)
    with open(path, "rb") as f:
        if f.readinto(buf) != len(buf):
            raise ValueError(f"{path}: short read")
    return unpackb(buf)
