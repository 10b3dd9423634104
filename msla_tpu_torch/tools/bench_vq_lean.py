"""The lean fused-VQ forward against the fused forward the VQ-VAE trains with.

Port of tools/bench_vq_lean.py. The lean forward (``ops.vq_lean_fwd``, kernel
#8) emits ids, counts and Σ‖q − x‖² taken as Σ(‖x‖² + min_k(‖e_k‖² −
2·x·e_k)), and gathers q outside its kernel; the shipping one
(``ops.vq_fused_fwd``, #4) copies q and sums (q − x)². The algebraic sum
cancels where q ≈ x, so both are compared at two regimes of a random
codebook: random rows, and rows that are codebook rows plus 1e-3 noise.
Prints ids that differ, whether the counts are equal, the largest q error,
the sum's relative error, and each forward's ms.

    python -m msla_tpu_torch.tools.bench_vq_lean     # on the card

``main(device="cpu", n=...)`` runs the plain versions on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from msla_tpu_torch.device import resolve_device
from msla_tpu_torch.ops import vq_fused_fwd, vq_lean_fwd
from msla_tpu_torch.tools import loop_ms

N, D, K = 64 * 11000, 64, 512
TILE = 2048  # the TPU kernel's row tile; the port's kernels take any N unpadded
ITERS = 10


def inputs(n: int = N, device: str | torch.device = "cpu"):
    """(codebook, random rows, converged rows) as fp32 tensors, drawn from
    ``default_rng(0)`` in the JAX tool's order."""
    rng = np.random.default_rng(0)
    cb = rng.standard_normal((K, D)).astype(np.float32)
    x_rand = rng.standard_normal((n, D)).astype(np.float32)
    rows = rng.integers(0, K, n)
    x_conv = (cb[rows] + 1e-3 * rng.standard_normal((n, D))).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (cb, x_rand, x_conv))


def main(device: str | torch.device | None = None, n: int = N) -> dict:
    dev = resolve_device(device)
    cb, x_rand, x_conv = inputs(n, dev)
    out = {}
    for name, x in (("random", x_rand), ("converged", x_conv)):
        q0, i0, c0, s0 = vq_fused_fwd(x, cb)
        q1, i1, c1, s1 = vq_lean_fwd(x, cb)
        r = dict(idx_mismatch=int((i0 != i1).sum()), counts_equal=bool(torch.equal(c0, c1)),
                 q_max_err=float((q0 - q1).abs().max()),
                 sq_rel_err=abs(float(s1 - s0)) / max(float(s0), 1e-9), sq=float(s0))
        print(f"[{name}] idx mismatch {r['idx_mismatch']}/{n} "
              f"| counts equal {r['counts_equal']} | q max err {r['q_max_err']:.2e} "
              f"| sq rel err {r['sq_rel_err']:.2e} (sq={r['sq']:.4e})", flush=True)
        out[name] = r
    for name, fn in (("shipping", vq_fused_fwd), ("lean", vq_lean_fwd)):
        out[f"{name}_ms"] = loop_ms(lambda: fn(x_rand, cb), dev, ITERS)
        print(f"fwd {name:<8s}: {out[f'{name}_ms']:7.2f} ms", flush=True)
    return out


if __name__ == "__main__":
    main()
