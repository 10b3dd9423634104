"""ctypes binding to the C++ IO library of the repository, native/msla_io.cpp
(after msla_tpu/data/native.py).

The dataset's cleaning pass runs its three steps through it: WAV decode
(``msla_wav_info``, ``msla_decode_wav``), polyphase resampling
(``msla_resample_poly``) and the frame scan (``msla_frame_index``).

At first use the source is compiled with ``g++`` and the flags of
native/Makefile into ``build/msla_tpu_torch/libmsla_io.so``, so the library
computes the same bits as the JAX package's build of the same source on the
same machine; native/ itself is never written. Beside it,
``libmsla_io.stamp`` holds a hash of the source, the flags and the host's
CPU (``-march=native`` code may not run on another); a library whose stamp
differs is rebuilt. A failed build, load or call raises: there is no quiet
fallback. The numpy and scipy functions of ``data/wavio.py`` and
``data/resample.py`` are the plain versions the tests hold these against.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from math import gcd
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "msla_io.cpp"
LIB_PATH = Path(__file__).resolve().parents[2] / "build" / "msla_tpu_torch" / "libmsla_io.so"
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]  # native/Makefile:2

_lib: ctypes.CDLL | None = None


class _WavInfo(ctypes.Structure):
    _fields_ = [("channels", ctypes.c_int32),
                ("sample_rate", ctypes.c_int32),
                ("frames", ctypes.c_int64)]


def _stamp() -> str:
    """Hash of the source, the flags and the CPU they compile for."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    try:
        with open("/proc/cpuinfo") as f:
            cpu = sorted({ln for ln in f if ln.startswith(("model name", "flags"))})
    except OSError:  # not Linux
        cpu = [platform.processor()]
    h.update("".join(cpu).encode())
    return h.hexdigest()


def build() -> Path:
    """Compile the library unless a build of this source, with these flags, for
    this CPU exists."""
    stamp, stamp_path = _stamp(), LIB_PATH.with_suffix(".stamp")
    if LIB_PATH.exists() and stamp_path.exists() and stamp_path.read_text() == stamp:
        return LIB_PATH
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"no C++ compiler (g++ or $CXX) to build {SOURCE}")
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE} failed (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIB_PATH)  # atomic: another process never loads half a file
    tmp_stamp = stamp_path.with_name(f"{stamp_path.name}.{os.getpid()}.tmp")
    tmp_stamp.write_text(stamp)
    os.replace(tmp_stamp, stamp_path)
    return LIB_PATH


def get_lib() -> ctypes.CDLL:
    """The loaded library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i64 = ctypes.c_int64
        lib.msla_wav_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(_WavInfo)]
        lib.msla_wav_info.restype = ctypes.c_int
        lib.msla_decode_wav.argtypes = [ctypes.c_char_p, f32, i64, ctypes.POINTER(_WavInfo)]
        lib.msla_decode_wav.restype = ctypes.c_int
        lib.msla_resample_poly.argtypes = [f32, i64, i64, i64, f32, i64, ctypes.POINTER(i64)]
        lib.msla_resample_poly.restype = ctypes.c_int
        lib.msla_frame_index.argtypes = [f32, i64, i64, i64, i64, i64,
                                         np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")]
        lib.msla_frame_index.restype = i64
        _lib = lib
    return _lib


def read_wav(path) -> tuple[np.ndarray, int]:
    """WAV file → (audio (channels, samples) float32 in [-1, 1], sample_rate)."""
    lib = get_lib()
    name = str(path).encode()
    info = _WavInfo()
    rc = lib.msla_wav_info(name, ctypes.byref(info))
    if rc != 0:
        raise ValueError(f"{path}: not a readable WAV file (msla_wav_info returned {rc})")
    out = np.empty(int(info.channels) * int(info.frames), np.float32)
    rc = lib.msla_decode_wav(name, out, info.frames, ctypes.byref(info))
    if rc != 0:
        raise ValueError(f"{path}: unsupported WAV encoding (msla_decode_wav returned {rc})")
    return out.reshape(int(info.channels), int(info.frames)), int(info.sample_rate)


def resample(audio: np.ndarray, orig_freq: int, new_freq: int) -> np.ndarray:
    """Resample (samples,) or (channels, samples) float audio over the
    gcd-reduced ratio (scipy's resample_poly filter: Kaiser(5.0) windowed sinc,
    half length 10·max(up, down))."""
    if orig_freq == new_freq:
        return np.asarray(audio, dtype=np.float32)
    lib = get_lib()
    g = gcd(int(orig_freq), int(new_freq))
    up, down = new_freq // g, orig_freq // g
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    rows = audio[None] if audio.ndim == 1 else audio
    outs = []
    for row in rows:
        cap = (row.shape[-1] * up) // down + 2
        out = np.empty(cap, np.float32)
        n_out = ctypes.c_int64()
        rc = lib.msla_resample_poly(row, row.shape[-1], up, down, out, cap,
                                    ctypes.byref(n_out))
        if rc != 0:
            raise RuntimeError(f"msla_resample_poly returned {rc} ({orig_freq} → {new_freq} Hz)")
        outs.append(out[: n_out.value])
    result = np.stack(outs)
    return result[0] if audio.ndim == 1 else result


def frame_index(stems: np.ndarray, sample_rate: int, frame_len: int,
                max_duration: int) -> np.ndarray:
    """Starts of the complete, non-silent (``int(sum) != 0``) windows of
    ``frame_len`` samples at a 1 s hop over the first ``max_duration``
    seconds of (channels, samples) stems."""
    stems = np.ascontiguousarray(stems, dtype=np.float32)
    starts = np.empty(max_duration, np.int64)
    n = get_lib().msla_frame_index(stems, stems.shape[0], stems.shape[1], sample_rate,
                                   frame_len, max_duration, starts)
    return starts[: int(n)]
