"""Waveform encoder (port of msla_tpu/nn/encoder.py with fuse_stem=True).

Fused stem (conv k4s2p1 + ReLU → conv k4s2p1 + ReLU, the ``conv_stem`` kernel)
→ conv k3s1p1 → ResidualStack. (B, 4, T) → (B, num_hidden, T/4), NCW.
The stem's weights live in ``conv1``/``conv2`` modules so the state_dict keeps
the reference's key names; their forward is never called.
"""
from __future__ import annotations

import torch
from torch import nn

from msla_tpu_torch.nn.layers import conv1d
from msla_tpu_torch.nn.residual_stack import ResidualStack
from msla_tpu_torch.ops.conv_stem import conv_stem


class Encoder(nn.Module):
    def __init__(self, num_hidden: int, num_residual_layer: int, num_residual_hidden: int,
                 in_channels: int = 4, *, generator: torch.Generator, device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.conv1 = conv1d(in_channels, num_hidden // 2, 4, 2, 1, **kw)
        self.conv2 = conv1d(num_hidden // 2, num_hidden, 4, 2, 1, **kw)
        self.conv3 = conv1d(num_hidden, num_hidden, 3, 1, 1, **kw)
        self.residual_stack = ResidualStack(num_hidden, num_residual_layer,
                                            num_residual_hidden, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv_stem(x, self.conv1.weight, self.conv1.bias,
                      self.conv2.weight, self.conv2.bias)
        return self.residual_stack(self.conv3(x))
