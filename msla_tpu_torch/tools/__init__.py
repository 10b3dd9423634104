"""The port's measurement tools, each run as ``python -m msla_tpu_torch.tools.<name>``:
``bench_vq_lean`` (the lean fused-VQ forward against the fused one),
``bench_vq_precision`` (the fused VQ's bf16 precision variants) and
``bench_stems`` (the fp32 stems beside probes of their parts)."""
from __future__ import annotations

import time

import torch


def loop_ms(fn, device: torch.device, iters: int) -> float:
    """Mean ms of one ``fn()`` over ``iters`` runs, after one run to warm up:
    between two CUDA events on the card, on the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters
