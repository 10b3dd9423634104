"""Build the CUDA kernels under ``csrc/``, bind them with ctypes, and check
what a wrapper hands them.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own, with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``,
into ``build/msla_tpu_torch/<name>.<hash>.so`` at the repository root. The hash
is the source's, so an edited source is rebuilt at its next use and an
unchanged one is loaded as it is. ``build_all`` starts one ``nvcc`` per source,
all at once, and waits for them.

Nothing here runs when a module is imported: a kernel is built and loaded at
its first launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "msla_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong

#: C entry point of each source and its argument types (pointers and the
#: stream as c_void_p, so ctypes does not cut them to 32 bits)
SIGNATURES = {
    "conv_stem": ("conv_stem_fwd", [P, P, P, P, P, P, I32, I32, P]),
    "deconv_stem": ("deconv_stem_fwd", [P, P, P, P, P, P, I32, I32, P]),
    "nearest_codes": ("nearest_codes_fwd", [P, P, P, P, I64, I32, P]),
}

_loaded: dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}.{digest}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start nvcc for ``name`` unless its current library exists."""
    lib = library_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish(name: str, job: tuple[subprocess.Popen, Path, Path]) -> None:
    proc, tmp, lib = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, lib)  # atomic: another process never loads half a file


def build_all(names=tuple(SIGNATURES)) -> None:
    """Build every stale kernel library, one nvcc per source, in parallel."""
    jobs = {n: _start(n) for n in names}
    errors = []
    for n, job in jobs.items():
        if job is None:
            continue
        try:
            _finish(n, job)
        except RuntimeError as e:  # finish the other builds, then report all
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def kernel(name: str):
    """The bound C entry point of ``csrc/<name>.cu``, built at first use."""
    fn = _loaded.get(name)
    if fn is None:
        build_all((name,))
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(library_path(name))), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn


def check(name: str, status: int) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {status}")


def forward_only(name: str, *tensors) -> None:
    """The kernels have no backward yet: refuse inputs that need one."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} is forward-only: its backward kernel comes with the training "
            "slice (ROADMAP.md, queue item 2); call it under torch.no_grad()")


def on_one_device(name: str, *tensors) -> torch.device:
    """All inputs on one device, CPU or CUDA; returns it."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors) or dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: inputs must share one cpu or cuda device, got "
                         f"{[str(t.device) for t in tensors]}")
    return dev


def require(name: str, t: torch.Tensor, what: str, shape: tuple) -> None:
    """A CUDA kernel's operand: fp32, contiguous, of exactly ``shape``."""
    if t.dtype != torch.float32 or not t.is_contiguous() or tuple(t.shape) != shape:
        raise ValueError(f"{name}: {what} must be a contiguous float32 tensor of shape "
                         f"{shape}, got {t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
