"""Waveform encoder (port of msla_tpu/nn/encoder.py with fuse_stem=True).

Fused stem (conv k4s2p1 + ReLU → conv k4s2p1 + ReLU, the ``conv_stem`` kernel)
→ conv k3s1p1 → ResidualStack. (B, 4, T) → (B, num_hidden, T/4), NCW. With
``dtype`` bf16 the stem takes bf16 x, w1 and w2 (the biases stay fp32) and
everything after it runs in bf16, as the JAX encoder with ``dtype="bfloat16"``.
The stem's weights live in ``conv1``/``conv2`` modules so the state_dict keeps
the reference's key names; their forward is never called.
"""
from __future__ import annotations

import torch
from torch import nn

from msla_tpu_torch.nn.layers import conv, conv1d
from msla_tpu_torch.nn.residual_stack import ResidualStack
from msla_tpu_torch.ops.conv_stem import conv_stem


class Encoder(nn.Module):
    def __init__(self, num_hidden: int, num_residual_layer: int, num_residual_hidden: int,
                 in_channels: int = 4, *, generator: torch.Generator, device,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        kw = dict(generator=generator, device=device)
        self.conv1 = conv1d(in_channels, num_hidden // 2, 4, 2, 1, **kw)
        self.conv2 = conv1d(num_hidden // 2, num_hidden, 4, 2, 1, **kw)
        self.conv3 = conv1d(num_hidden, num_hidden, 3, 1, 1, **kw)
        self.residual_stack = ResidualStack(num_hidden, num_residual_layer,
                                            num_residual_hidden, dtype=dtype, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w1, w2 = self.conv1.weight, self.conv2.weight
        if self.dtype is not None:
            x, w1, w2 = x.to(self.dtype), w1.to(self.dtype), w2.to(self.dtype)
        x = conv_stem(x, w1, self.conv1.bias, w2, self.conv2.bias)
        return self.residual_stack(conv(self.conv3, x, self.dtype))
