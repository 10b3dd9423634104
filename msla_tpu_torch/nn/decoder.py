"""Latent-to-waveform decoder (port of msla_tpu/nn/decoder.py with fuse_stem=True).

Conv k3s1p1 → ResidualStack → fused stem (convT k4s2p1 + ReLU → convT k4s2p1,
the ``deconv_stem`` kernel). (B, embedding_dim, W) → (B, 4, 4W) fp32, NCW.
With ``dtype`` bf16 everything up to the stem's output runs in bf16 (the
stem's biases stay fp32), and the output is cast to fp32, as the JAX decoder
with ``dtype="bfloat16"``.
The stem's weights live in ``conv1_transpose``/``conv2_transpose`` modules so
the state_dict keeps the reference's key names; their forward is never called.
"""
from __future__ import annotations

import torch
from torch import nn

from msla_tpu_torch.nn.layers import conv, conv1d, conv_transpose1d
from msla_tpu_torch.nn.residual_stack import ResidualStack
from msla_tpu_torch.ops.deconv_stem import deconv_stem


class Decoder(nn.Module):
    def __init__(self, in_channels: int, num_hidden: int, num_residual_layer: int,
                 num_residual_hidden: int, out_channels: int = 4, *,
                 generator: torch.Generator, device, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        kw = dict(generator=generator, device=device)
        self.conv1 = conv1d(in_channels, num_hidden, 3, 1, 1, **kw)
        self.residual_stack = ResidualStack(num_hidden, num_residual_layer,
                                            num_residual_hidden, dtype=dtype, **kw)
        self.conv1_transpose = conv_transpose1d(num_hidden, num_hidden // 2, 4, 2, 1, **kw)
        self.conv2_transpose = conv_transpose1d(num_hidden // 2, out_channels, 4, 2, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.residual_stack(conv(self.conv1, x, self.dtype))
        w1, w2 = self.conv1_transpose.weight, self.conv2_transpose.weight
        if self.dtype is not None:
            w1, w2 = w1.to(self.dtype), w2.to(self.dtype)
        out = deconv_stem(x, w1, self.conv1_transpose.bias, w2, self.conv2_transpose.bias)
        return out.float()
