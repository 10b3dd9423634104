"""Build the CUDA kernels under ``csrc/``, bind them with ctypes, and check
what a wrapper hands them.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own, with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``,
into ``build/msla_tpu_torch/<name>.<hash>.so`` at the repository root, beside
``<name>.<hash>.log`` (what ``-Xptxas=-v`` reports: registers, spills). The
hash covers the source, the shared ``csrc/*.cuh`` headers and the flags, so an
edited source is rebuilt at its next use and an unchanged one is loaded as it
is. One source may export several entry points. ``build_all`` starts one
``nvcc`` per source, all at once, and waits for them.

Nothing here runs when a module is imported: a kernel is built and loaded at
its first launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "msla_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

#: dynamic shared memory one block may use on Hopper
SMEM_BYTES = 232_448

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
F32 = ctypes.c_float

#: each C entry point: the source that exports it and its argument types
#: (pointers and the stream as c_void_p, so ctypes does not cut them to 32 bits)
SIGNATURES = {
    "conv_stem_fwd": ("conv_stem", [P, P, P, P, P, P, P, I32, I32, I32, I32, P]),
    "conv_stem_smem_bytes": ("conv_stem", [I32, I32]),
    "conv_stem_bf16_fwd": ("conv_stem", [P, P, P, P, P, P, P, I32, I32, P]),
    "deconv_stem_fwd": ("deconv_stem", [P, P, P, P, P, P, P, I32, I32, I32, I32, P]),
    "deconv_stem_smem_bytes": ("deconv_stem", [I32, I32]),
    "deconv_stem_bf16_fwd": ("deconv_stem", [P, P, P, P, P, P, P, I32, I32, P]),
    "conv_stem_any_fwd": ("stem_any", [I32, P, P, P, P, P, P, P, I32, I32, I32, I32, I32, P]),
    "deconv_stem_any_fwd": ("stem_any", [I32, P, P, P, P, P, P, P, I32, I32, I32, I32, I32, P]),
    "stem_any_smem_bytes": ("stem_any", [I32, I32, I32, I32, I32]),
    "nearest_codes_fwd": ("nearest_codes", [P, P, P, P, I64, I32, I32, P]),
    "vq_search_smem_bytes": ("nearest_codes", [I32, I32, I32]),
    "vq_any_fwd": ("vq_any", [P, P, P, P, P, P, P, P, P, I32, I64, I32, I32, I32, I32, P]),
    "vq_any_smem_bytes": ("vq_any", [I32, I32, I32]),
    "vq_fused_fwd": ("vq_fused", [P, P, P, P, P, P, P, P, P, I32, I64, I32, I32, P]),
    "vq_codebook_grad": ("vq_fused", [P, P, P, P, I32, I64, I64, I32, I32, I32, P]),
    "vq_codebook_grad_clusters": ("vq_fused", [I32, P]),
    "flash_attn_fwd": ("flash_attn", [P, P, P, P, P, P, P, I32, I32, I32, I32, F32, P]),
    "flash_attn_bf16_fwd": ("flash_attn", [P, P, P, P, P, P, P, I32, I32, I32, I32, F32, P]),
    "flash_any_fwd": ("flash_any", [I32, P, P, P, P, P, P, P, I32, I32, I32, I32, I32, F32, P]),
    "flash_any_smem_bytes": ("flash_any", [I32, I32]),
    "flash_bwd_dq": ("flash_bwd", [I32, P, P, P, P, P, P, P, P, P, P, I32, I32, I32, I32, I32,
                                   F32, P]),
    "flash_bwd_dkv": ("flash_bwd", [I32, P, P, P, P, P, P, P, P, P, P, I32, I32, I32, I32, I32,
                                    F32, P, P]),
    "flash_bwd_smem_bytes": ("flash_bwd", [I32, I32, I32]),
    "mlm_argmax_fwd": ("mlm_argmax", [P, P, P, P, I64, I32, P]),
    "mlm_argmax_conf_fwd": ("mlm_argmax", [P, P, P, P, P, I64, I32, P]),
    "mlm_argmax_bf16_fwd": ("mlm_argmax", [P, P, P, P, I64, I32, P]),
    "mlm_argmax_conf_bf16_fwd": ("mlm_argmax", [P, P, P, P, P, I64, I32, P]),
    "mlm_argmax_bf16_probe": ("mlm_argmax_probe", [I32, I32, P, P, P, P, P, I64, I32, P]),
    "vq_lean_fwd": ("vq_lean", [P, P, P, P, P, P, P, P, I32, I64, I32, P]),
    "vq_precision_fwd": ("vq_precision", [I32, I32, P, P, P, P, P, P, P, P, P, P, P, I32, I64,
                                          I32, P]),
    "vq_precision_bwd_split2": ("vq_precision", [P, P, P, P, I32, I64, I64, I32, P]),
    "vq_precision_bwd_split2_clusters": ("vq_precision", [I32, P]),
}
SOURCES = tuple(sorted({source for source, _ in SIGNATURES.values()}))

_libraries: dict[str, ctypes.CDLL] = {}
_loaded: dict[str, ctypes._CFuncPtr] = {}
#: the wall seconds of each nvcc this process ran, by source
NVCC_SECONDS: dict[str, float] = {}


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
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}.{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """What nvcc and ptxas printed when ``csrc/<name>.cu`` was built."""
    return library_path(name).with_suffix(".log").read_text()


def _start(name: str) -> tuple[subprocess.Popen, Path, Path, float] | None:
    """Start nvcc for ``name`` unless its current library exists; what it
    prints goes to a file beside the library (no pipe to fill)."""
    lib = library_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    with open(tmp.with_suffix(".log"), "w") as out:
        proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT)
    return proc, tmp, lib, time.perf_counter()


def _finish(name: str, job: tuple[subprocess.Popen, Path, Path, float]) -> None:
    proc, tmp, lib, _ = job
    log_path = tmp.with_suffix(".log")
    log = log_path.read_text()
    log_path.unlink(missing_ok=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    lib.with_suffix(".log").write_text(log)
    os.replace(tmp, lib)  # atomic: another process never loads half a file


def build_all(names=SOURCES) -> None:
    """Build every stale kernel library, one nvcc per source, all at once;
    each one's wall seconds, from its start to its exit, go to
    ``NVCC_SECONDS``."""
    jobs = {n: job for n in names if (job := _start(n)) is not None}
    errors = []
    while jobs:
        for n, job in list(jobs.items()):
            if job[0].poll() is None:
                continue
            NVCC_SECONDS[n] = time.perf_counter() - job[3]
            del jobs[n]
            try:
                _finish(n, job)
            except RuntimeError as e:  # finish the other builds, then report all
                errors.append(str(e))
        time.sleep(0.05)
    if errors:
        raise RuntimeError("\n".join(errors))


def kernel(symbol: str):
    """The bound C entry point ``symbol``, its source built at first use."""
    fn = _loaded.get(symbol)
    if fn is None:
        source, argtypes = SIGNATURES[symbol]
        lib = _libraries.get(source)
        if lib is None:
            build_all((source,))
            lib = _libraries[source] = ctypes.CDLL(str(library_path(source)))
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[symbol] = fn
    return fn


def check(name: str, status: int) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {status}")


def on_one_device(name: str, *tensors) -> torch.device:
    """All inputs on one device, CPU or CUDA; returns it."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors) or dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: inputs must share one cpu or cuda device, got "
                         f"{[str(t.device) for t in tensors]}")
    return dev


def runs_plain(name: str, *tensors) -> bool:
    """Whether a wrapper runs its plain version: only on CPU tensors. On CUDA
    tensors it launches its kernel or raises."""
    return on_one_device(name, *tensors).type == "cpu"


def needs_grad(*tensors) -> bool:
    """Whether autograd would record an op on these inputs."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def require(name: str, t: torch.Tensor, what: str, shape: tuple,
            dtype: torch.dtype = torch.float32) -> None:
    """A CUDA kernel's operand: contiguous, of ``dtype`` and exactly ``shape``."""
    if t.dtype != dtype or not t.is_contiguous() or tuple(t.shape) != shape:
        raise ValueError(f"{name}: {what} must be a contiguous {dtype} tensor of shape "
                         f"{shape}, got {t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data does not start on 16 bytes, as a
    TMA copy or a kernel's 16-byte loads need."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def count_launch(wrapper, key, widths: tuple | None = None) -> None:
    """One launch of a wrapper's kernel. Each wrapper's ``.launches`` is a
    Counter of its launches by operand type (by "dist/quant" mode for
    ``vq_precision_fwd``); ``launch_count`` reads it. A wrapper compiled for
    several widths also counts the launch in ``.widths``, a Counter by
    (operand type, widths): the stems' (C1, C2) or (C, C1), the VQ
    kernels' (D, K)."""
    wrapper.launches[key] += 1
    if widths is not None:
        wrapper.widths[key, widths] += 1


def launch_count(wrapper, key=None) -> int:
    """A wrapper's launches: all of them, or those of one key."""
    return sum(wrapper.launches.values()) if key is None else wrapper.launches[key]


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a card: the most blocks a persistent
    kernel launches, and so the most per-block partials it writes."""
    return torch.cuda.get_device_properties(device).multi_processor_count
