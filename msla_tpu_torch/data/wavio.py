"""WAV codec in numpy (the port's copy of msla_tpu/data/wavio.py; reference:
torchaudio.load/save in src/data/dataset.py:133, src/model/vqvae.py:203).

Reads PCM 8/16/24/32-bit and IEEE float32/64 WAVs, the extensible format tag
included, into float32 arrays in [-1, 1], shape (channels, samples); writes
PCM16 or float32. ``read_wav`` is the plain version of the native decoder
(``data/native.py``) that the tests hold it against.
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """Read a WAV file → (audio (channels, samples) float32 in [-1,1], sample_rate)."""
    data = Path(path).read_bytes()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")

    pos = 12
    fmt = None
    fmt_body = b""
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos:pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8: pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
            fmt_body = body
        elif chunk_id == b"data":
            raw = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned

    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == _WAVE_FORMAT_EXTENSIBLE and len(fmt_body) >= 26:
        # SubFormat GUID's first two bytes carry the real format tag
        (audio_format,) = struct.unpack_from("<H", fmt_body, 24)
    if audio_format == _WAVE_FORMAT_PCM:
        if bits == 8:
            x = (data_to_np(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = data_to_np(raw, np.int16).astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8)
            b = b[: (len(b) // 3) * 3].reshape(-1, 3)
            vals = (b[:, 0].astype(np.int32)
                    | (b[:, 1].astype(np.int32) << 8)
                    | (b[:, 2].astype(np.int32) << 16))
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            x = vals.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = data_to_np(raw, np.int32).astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_format == _WAVE_FORMAT_IEEE_FLOAT:
        dtype = np.float32 if bits == 32 else np.float64
        x = data_to_np(raw, dtype).astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported WAV format tag {audio_format}")

    x = x[: (x.size // channels) * channels].reshape(-1, channels).T
    return np.ascontiguousarray(x), sample_rate


def data_to_np(raw: bytes, dtype) -> np.ndarray:
    arr = np.frombuffer(raw, dtype=dtype)
    return arr


def write_wav(path: str | Path, audio: np.ndarray, sample_rate: int,
              dtype: str = "int16") -> None:
    """Write (channels, samples) or (samples,) float audio to a WAV file."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[None]
    interleaved = audio.T  # (samples, channels)
    channels = interleaved.shape[1]

    if dtype == "int16":
        fmt_tag, bits = _WAVE_FORMAT_PCM, 16
        payload = (np.clip(interleaved, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
    elif dtype == "float32":
        fmt_tag, bits = _WAVE_FORMAT_IEEE_FLOAT, 32
        payload = interleaved.astype("<f4").tobytes()
    else:
        raise ValueError(f"unsupported write dtype {dtype}")

    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    header = b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
    header += b"fmt " + struct.pack("<IHHIIHH", 16, fmt_tag, channels, sample_rate,
                                    byte_rate, block_align, bits)
    header += b"data" + struct.pack("<I", len(payload))
    Path(path).write_bytes(header + payload)
