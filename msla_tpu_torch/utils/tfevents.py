"""TensorBoard event files, written without tensorboard or tensorboardX (the
port's counterpart of tensorboardX's ``SummaryWriter`` as
msla_tpu/train/loggers.py:43-76 uses it: ``add_scalar``, ``add_text``).

A file ``events.out.tfevents.<secs>.<host>`` is a sequence of TFRecords, each

    u64 length | u32 masked CRC32C of the length | data | u32 masked CRC32C of the data

(little-endian), whose data is one ``tensorboard.Event`` protobuf. The first
record is an ``Event`` with ``file_version "brain.Event:2"``. The protobufs
are encoded here by hand in the wire format (varints, length-delimited
fields, fixed64 ``wall_time``, fixed32 ``simple_value``); fields at their
proto3 default are left out, as protobuf leaves them out, but ``simple_value``
and ``file_version`` sit in a ``oneof`` and are always written. The messages
and field numbers (tensorboard/compat/proto):

  Event            wall_time 1 (double), step 2 (int64), file_version 3,
                   summary 5
  Summary          value 1 (repeated Summary.Value)
  Summary.Value    tag 1, simple_value 2 (float), tensor 8, metadata 9
  SummaryMetadata  plugin_data 1 (PluginData: plugin_name 1, content 2)
  TensorProto      dtype 1 (DT_STRING = 7), tensor_shape 2 (TensorShapeProto:
                   dim 2, Dim: size 1), string_val 8 (repeated bytes)

Scalars are written as tensorboardX writes them, old style, as
``simple_value``; text as ``add_text`` writes it: the tag
``<tag>/text_summary``, the plugin ``text`` with empty content (its
``TextPluginData`` at version 0), a ``DT_STRING`` tensor of shape [1]. Tags
are cleaned as tensorboardX cleans them. CRC32C (Castagnoli) is table-driven
in Python.
"""
from __future__ import annotations

import re
import socket
import struct
import time
from pathlib import Path

import numpy as np

_CRC32C_POLY = 0x82F63B78  # the Castagnoli polynomial, bit-reversed
_MASK_DELTA = 0xA282EAD8
_DT_STRING = 7
_INVALID_TAG_CHARACTERS = re.compile(r"[^-/\w\.]")


def _crc32c_table() -> list[int]:
    table = []
    for byte in range(256):
        crc = byte
        for _ in range(8):
            crc = (crc >> 1) ^ _CRC32C_POLY if crc & 1 else crc >> 1
        table.append(crc)
    return table


_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC: the CRC rotated right by 15 bits, plus a constant."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def tfrecord(data: bytes) -> bytes:
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc32c(length)) + data
            + struct.pack("<I", masked_crc32c(data)))


# ---- protobuf wire format ------------------------------------------------------------
def _varint(value: int) -> bytes:
    value &= (1 << 64) - 1  # a negative int64 as its two's complement
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _key(field: int, wire_type: int) -> bytes:
    return _varint(field << 3 | wire_type)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _str_field(field: int, text: str) -> bytes:
    return _bytes_field(field, text.encode("utf-8"))


def _int_field(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value) if value else b""


def clean_tag(tag: str) -> str:
    """tensorboardX's ``_clean_tag``: characters outside [-/\\w.] become _,
    leading slashes go."""
    return _INVALID_TAG_CHARACTERS.sub("_", tag).lstrip("/")


def scalar_value(tag: str, value: float) -> bytes:
    """A ``Summary.Value`` with ``simple_value`` (fp32, as the field is)."""
    with np.errstate(over="ignore"):  # past fp32's range: inf, as protobuf stores it
        bits = np.array(value, dtype="<f4").tobytes()
    return _str_field(1, clean_tag(tag)) + _key(2, 5) + bits


def text_value(tag: str, text: str) -> bytes:
    """A ``Summary.Value`` of the text plugin, as tensorboardX's ``text``."""
    plugin = _bytes_field(1, _str_field(1, "text"))  # PluginData: content b"" left out
    shape = _bytes_field(2, _int_field(1, 1))         # TensorShapeProto: dim {size: 1}
    tensor = _int_field(1, _DT_STRING) + _bytes_field(2, shape) + _bytes_field(
        8, text.encode("utf-8"))
    return _str_field(1, tag + "/text_summary") + _bytes_field(8, tensor) + _bytes_field(9, plugin)


def event(wall_time: float, step: int | None = None, *, file_version: str | None = None,
          values: tuple[bytes, ...] = ()) -> bytes:
    """An ``Event``: a file version, or a ``Summary`` of ``values``."""
    out = _key(1, 1) + struct.pack("<d", wall_time)
    if step is not None:
        out += _int_field(2, int(step))
    if file_version is not None:
        out += _str_field(3, file_version)
    if values:
        out += _bytes_field(5, b"".join(_bytes_field(1, v) for v in values))
    return out


class EventFileWriter:
    """Appends events to ``<logdir>/events.out.tfevents.<secs>.<host>``, a
    record at a time, flushed as it is written. The file is opened, with its
    version record, when the writer is made and again at the first write
    after ``close`` (a new file, as tensorboardX's writer reopens)."""

    def __init__(self, logdir: str | Path):
        self.logdir = Path(logdir)
        self.path: Path | None = None
        self._file = None
        self._open()

    def _open(self) -> None:
        self.logdir.mkdir(parents=True, exist_ok=True)
        now = time.time()
        self.path = self.logdir / f"events.out.tfevents.{str(now)[:10]}.{socket.gethostname()}"
        self._file = open(self.path, "ab")  # a reopen in the same second goes on in the file
        self._write(event(now, file_version="brain.Event:2"))

    def _write(self, data: bytes) -> None:
        if self._file is None:
            self._open()
        self._file.write(tfrecord(data))
        self._file.flush()

    def add_scalar(self, tag: str, value: float, step: int | None = None) -> None:
        self._write(event(time.time(), step, values=(scalar_value(tag, float(value)),)))

    def add_text(self, tag: str, text: str, step: int | None = None) -> None:
        self._write(event(time.time(), step, values=(text_value(tag, text),)))

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
