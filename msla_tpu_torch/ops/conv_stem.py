"""The VQ-VAE encoder stem: conv k4 s2 p1 + ReLU, then conv k4 s2 p1 + ReLU.

Port of msla_tpu/ops/conv_stem.py (forward). On a CUDA tensor ``conv_stem``
launches the hand-written kernel ``csrc/conv_stem.cu``, which keeps conv1's
(B, 64, T/2) output out of device memory; on a CPU tensor it runs
``conv_stem_ref``, the plain PyTorch version of the same arithmetic.

Layout is torch's: x (B, C0, T), weights (out, in, k), output (B, C2, T/4).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from msla_tpu_torch.ops._build import (check, forward_only, kernel, on_one_device,
                                       require, stream_of)

#: the widths the CUDA kernel is compiled for (the full-width model's)
C0, C1, C2 = 4, 64, 128


def _conv_k4s2p1_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    win = F.pad(x, (1, 1)).unfold(2, 4, 2)          # (B, C_in, T/2, 4) taps
    return torch.relu(torch.einsum("bcwt,oct->bow", win, w) + b[:, None])


def conv_stem_ref(x, w1, b1, w2, b2):
    """Plain version: both convs as explicit tap sums over zero-padded windows.
    conv2's padding pads relu(conv1), as in the kernel."""
    return _conv_k4s2p1_relu(_conv_k4s2p1_relu(x, w1, b1), w2, b2)


def conv_stem(x, w1, b1, w2, b2):
    """(B, C0, T) → (B, C2, T/4). T must be divisible by 4."""
    if x.dim() != 3 or x.shape[-1] % 4:
        raise ValueError(f"conv_stem needs (B, C, T) with T divisible by 4, got "
                         f"{tuple(x.shape)}")
    forward_only("conv_stem", x, w1, b1, w2, b2)
    if on_one_device("conv_stem", x, w1, b1, w2, b2).type == "cpu":
        return conv_stem_ref(x, w1, b1, w2, b2)

    b, _, t = x.shape
    require("conv_stem", x, "x", (b, C0, t))
    require("conv_stem", w1, "w1", (C1, C0, 4))
    require("conv_stem", b1, "b1", (C1,))
    require("conv_stem", w2, "w2", (C2, C1, 4))
    require("conv_stem", b2, "b2", (C2,))
    w1t = w1.permute(1, 2, 0).contiguous()  # [c0*4+tap][c1]
    w2t = w2.permute(1, 2, 0).contiguous()  # [c1*4+tap][c2]
    out = torch.empty((b, C2, t // 4), dtype=torch.float32, device=x.device)
    check("conv_stem", kernel("conv_stem")(
        x.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(), b2.data_ptr(),
        out.data_ptr(), b, t, stream_of(x)))
    conv_stem.launches += 1
    return out


conv_stem.launches = 0
