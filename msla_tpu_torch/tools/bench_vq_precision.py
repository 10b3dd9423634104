"""The fused VQ's precision variants: what a bf16 distance dot costs and flips.

Port of tools/bench_vq_precision.py. Forward pairs (dist_mode/quant_mode, see
``ops.vq_precision``): f32/f32 (the fused forward, #4), bf16/split2,
bf16/f32 and split3/split2; codebook gradients f32 (#5) and split2. The rows
are bf16-rounded, as a bf16 encoder would hand them to the VQ. Prints each
variant's ms and, against the f32 one, the ids it flips, its largest q error
and the sum's relative error (forward) or the largest gradient error
relative to the largest f32 entry (gradient).

    python -m msla_tpu_torch.tools.bench_vq_precision     # on the card

``main(device="cpu", n=...)`` runs the plain versions on the CPU.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from msla_tpu_torch.device import resolve_device
from msla_tpu_torch.ops import vq_precision_bwd, vq_precision_fwd
from msla_tpu_torch.ops.vq_precision import check_grad_mode, check_modes
from msla_tpu_torch.tools import loop_ms

N, D, K = 64 * 11000, 64, 512
TILE = 2048  # the TPU kernel's row tile; the port's kernels take any N unpadded
ITERS = 10
FWD_MODES = (("f32/f32", ("f32", "f32")), ("bf16/split2", ("bf16", "split2")),
             ("bf16/f32", ("bf16", "f32")), ("split3/split2", ("split3", "split2")))
BWD_MODES = ("f32", "split2")


def make_fwd(dist_mode: str, quant_mode: str):
    """The forward in one precision pair: (flat_x, codebook) → (q, idx, counts, sq)."""
    check_modes(dist_mode, quant_mode)
    return functools.partial(vq_precision_fwd, dist_mode=dist_mode, quant_mode=quant_mode)


def make_bwd(mode: str):
    """The codebook gradient in one mode: (g, idx) → (K, D)."""
    check_grad_mode(mode)
    return functools.partial(vq_precision_bwd, mode=mode, k=K)


def inputs(n: int = N, device: str | torch.device = "cpu"):
    """(bf16-rounded rows, codebook, gradient · 1e-3) as fp32 tensors, drawn
    from ``default_rng(0)`` in the JAX tool's order."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32)).to(device)
    cb = torch.from_numpy(rng.standard_normal((K, D)).astype(np.float32)).to(device)
    g = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32)).to(device)
    return x.to(torch.bfloat16).float(), cb, g * 1e-3


def main(device: str | torch.device | None = None, n: int = N) -> dict:
    dev = resolve_device(device)
    x, cb, g = inputs(n, dev)
    out = {"fwd": {}, "bwd": {}}
    ref = None
    for name, modes in FWD_MODES:
        fn = make_fwd(*modes)
        q, idx, _, sq = fn(x, cb)
        if ref is None:
            ref = (q, idx, sq)
        r = dict(idx_mismatch=int((idx != ref[1]).sum()),
                 q_max_err=float((q - ref[0]).abs().max()),
                 sq_rel_err=abs(float(sq - ref[2]) / float(ref[2])),
                 ms=loop_ms(lambda: fn(x, cb), dev, ITERS))
        print(f"fwd {name:<14s}: {r['ms']:7.2f} ms | idx mismatch {r['idx_mismatch']}/{n} "
              f"| max|q-ref| {r['q_max_err']:.2e} | sq rel err {r['sq_rel_err']:.2e}",
              flush=True)
        out["fwd"][name] = r

    idx = make_fwd("f32", "f32")(x, cb)[1][:, 0]
    refb = None
    for name in BWD_MODES:
        fn = make_bwd(name)
        dcb = fn(g, idx)
        if refb is None:
            refb = dcb
        r = dict(rel_err=float((dcb - refb).abs().max() / (refb.abs().max() + 1e-30)),
                 ms=loop_ms(lambda: fn(g, idx), dev, ITERS))
        print(f"bwd {name:<14s}: {r['ms']:7.2f} ms | rel err {r['rel_err']:.2e}", flush=True)
        out["bwd"][name] = r
    return out


if __name__ == "__main__":
    main()
