"""The VQ-VAE decoder stem: convT k4 s2 p1 + ReLU, then convT k4 s2 p1.

Port of msla_tpu/ops/deconv_stem.py (forward). On a CUDA tensor
``deconv_stem`` launches the hand-written kernel ``csrc/deconv_stem.cu``,
which keeps the (B, 64, 2W) hidden out of device memory; on a CPU tensor it
runs ``deconv_stem_ref``, the plain PyTorch version of the same arithmetic.

A stride-2 transposed conv splits into two phases (torch weight (in, out, k)):
  out[2m]   = x[m]·W[..., 1] + x[m-1]·W[..., 3]
  out[2m+1] = x[m]·W[..., 2] + x[m+1]·W[..., 0]
Layout is torch's: q (B, C, W), output (B, C_out, 4W).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from msla_tpu_torch.ops._build import (check, forward_only, kernel, on_one_device,
                                       require, stream_of)

#: the widths the CUDA kernel is compiled for (the full-width model's)
C, C1, C_OUT = 128, 64, 4


def _convt_k4s2p1(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    xp = F.pad(x, (1, 1))                             # x[m-1], x[m], x[m+1]
    prev, cur, nxt = xp[..., :-2], xp[..., 1:-1], xp[..., 2:]
    tap = lambda v, t: torch.einsum("bcw,co->bow", v, w[..., t])
    even = tap(cur, 1) + tap(prev, 3)
    odd = tap(cur, 2) + tap(nxt, 0)
    out = torch.stack([even, odd], dim=-1).flatten(-2)  # interleave the phases
    return out + b[:, None]


def deconv_stem_ref(q, w1, b1, w2, b2):
    """Plain version: both transposed convs as explicit phase sums."""
    return _convt_k4s2p1(torch.relu(_convt_k4s2p1(q, w1, b1)), w2, b2)


def deconv_stem(q, w1, b1, w2, b2):
    """(B, C, W) → (B, C_out, 4W); ReLU after the first layer only."""
    if q.dim() != 3:
        raise ValueError(f"deconv_stem needs (B, C, W), got {tuple(q.shape)}")
    forward_only("deconv_stem", q, w1, b1, w2, b2)
    if on_one_device("deconv_stem", q, w1, b1, w2, b2).type == "cpu":
        return deconv_stem_ref(q, w1, b1, w2, b2)

    b, _, w = q.shape
    require("deconv_stem", q, "q", (b, C, w))
    require("deconv_stem", w1, "w1", (C, C1, 4))
    require("deconv_stem", b1, "b1", (C1,))
    require("deconv_stem", w2, "w2", (C1, C_OUT, 4))
    require("deconv_stem", b2, "b2", (C_OUT,))
    out = torch.empty((b, C_OUT, 4 * w), dtype=torch.float32, device=q.device)
    check("deconv_stem", kernel("deconv_stem")(
        q.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), b, w, stream_of(q)))
    deconv_stem.launches += 1
    return out


deconv_stem.launches = 0
