"""Residual conv stack (port of msla_tpu/nn/residual_stack.py).

N blocks of [ReLU → Conv k3 (no bias) → ReLU → Conv k1 (no bias)] with an
additive skip, then a final ReLU. Keys follow the reference's Sequential
(``residual_layers.{i}.1`` and ``.3``). NCW. With ``dtype`` bf16 the convs and
the stream run in bf16, as the JAX stack with ``dtype="bfloat16"``.
"""
from __future__ import annotations

import torch
from torch import nn

from msla_tpu_torch.nn.layers import conv, conv1d


class ResidualStack(nn.Module):
    def __init__(self, num_hidden: int, num_residual_layer: int, num_residual_hidden: int,
                 *, generator: torch.Generator, device, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.residual_layers = nn.ModuleList(
            nn.Sequential(
                nn.ReLU(),
                conv1d(num_hidden, num_residual_hidden, 3, 1, 1, bias=False,
                       generator=generator, device=device),
                nn.ReLU(),
                conv1d(num_residual_hidden, num_hidden, 1, 1, 0, bias=False,
                       generator=generator, device=device),
            )
            for _ in range(num_residual_layer))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.residual_layers:
            # Reference quirk: its blocks use nn.ReLU(inplace=True), which
            # mutates the skip operand before the addition, so the skip adds
            # relu(x), not x.
            x = torch.relu(x)
            h = conv(layer[3], torch.relu(conv(layer[1], x, self.dtype)), self.dtype)
            x = x + h
        return torch.relu(x)
