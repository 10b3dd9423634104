"""Conv wrappers with the reference's initialisers, drawn from an explicit
torch.Generator (port of msla_tpu/nn/layers.py).

Weights and biases are U(±1/√fan_in), the torch Conv1d default family that the
JAX package reproduces: fan_in is in·k for Conv1d's (out, in, k) weight and
out·k for ConvTranspose1d's (in, out, k) weight. Values are drawn on the CPU
and then moved, so one seed gives one model on every device.
"""
from __future__ import annotations

import torch
from torch import nn


def uniform_(t: torch.Tensor, limit: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        draw = torch.rand(t.shape, generator=generator, dtype=torch.float32)
        t.copy_(draw * (2 * limit) - limit)


def _init_conv(conv: nn.Module, fan_in: int, generator: torch.Generator) -> nn.Module:
    limit = 1.0 / fan_in ** 0.5
    uniform_(conv.weight, limit, generator)
    if conv.bias is not None:
        uniform_(conv.bias, limit, generator)
    return conv


def conv1d(cin: int, cout: int, kernel_size: int, stride: int = 1, padding: int = 0,
           bias: bool = True, *, generator: torch.Generator, device) -> nn.Conv1d:
    conv = nn.utils.skip_init(nn.Conv1d, cin, cout, kernel_size, stride=stride,
                              padding=padding, bias=bias, device=device)
    return _init_conv(conv, cin * kernel_size, generator)


def conv_transpose1d(cin: int, cout: int, kernel_size: int, stride: int = 1,
                     padding: int = 0, *, generator: torch.Generator,
                     device) -> nn.ConvTranspose1d:
    conv = nn.utils.skip_init(nn.ConvTranspose1d, cin, cout, kernel_size, stride=stride,
                              padding=padding, device=device)
    return _init_conv(conv, cout * kernel_size, generator)
