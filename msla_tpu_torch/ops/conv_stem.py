"""The VQ-VAE encoder stem: conv k4 s2 p1 + ReLU, then conv k4 s2 p1 + ReLU.

Port of msla_tpu/ops/conv_stem.py. On CUDA tensors the hand-written kernel
``csrc/conv_stem.cu`` runs the forward: ``conv_stem`` launches it without the
hidden (K1, which keeps conv1's (B, 64, T/2) output out of device memory), and
``conv_stem_save_hidden`` launches it with the hidden (K1b). On CPU tensors
both run ``conv_stem_ref``, the plain PyTorch version of the same arithmetic.

Under autograd, ``conv_stem`` is an ``autograd.Function`` whose forward is
K1b and whose backward is the JAX package's ``_fused_bwd``
(msla_tpu/ops/conv_stem.py:177-190): ReLU masks from the saved outputs and the
exact conv adjoints (cuDNN on the card), with no forward recompute. The
Function is the same on both devices.

The bf16 compute_dtype runs the Pallas kernel's bf16 function
(msla_tpu/ops/conv_stem.py:54-80): x, w1 and w2 bf16, the biases fp32, the
products summed in fp32, h1 rounded to bf16 before conv2 (and saved so by
K1b) and a bf16 output. The operand type is x's. Its backward is
``_fused_bwd`` on bf16 operands: the output gradient masked and cast to bf16,
the conv adjoints in bf16 (``conv_grads``), dh1 masked by h1 > 0 and kept
bf16, the biases' gradients summed in fp32.

Any length T >= 4: the output has floor(T/4) columns and the hidden floor(T/2),
as the JAX package's XLA stem gives them.

Layout is torch's: x (B, C0, T), weights (out, in, k), output (B, C2, T/4),
hidden (B, C1, T/2).
"""
from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

from msla_tpu_torch.ops._build import (check, count_launch, kernel, needs_grad, require,
                                       runs_plain, stream_of)
from msla_tpu_torch.ops.conv_adjoints import conv_grads

#: the widths the CUDA kernel is compiled for (the full-width model's)
C0, C1, C2 = 4, 64, 128


def _conv_k4s2p1_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    win = F.pad(x, (1, 1)).unfold(2, 4, 2)          # (B, C_in, T/2, 4) taps
    return torch.relu(torch.einsum("bcwt,oct->bow", win, w) + b[:, None])


def conv_stem_ref(x, w1, b1, w2, b2):
    """Plain version: both convs as explicit tap sums over zero-padded windows.
    conv2's padding pads relu(conv1), as in the kernel. In x's type: for bf16
    the sums run in fp32 on the exact products and h1 and the output are
    rounded to bf16. Returns (out, h1)."""
    dt = x.dtype
    h1 = _conv_k4s2p1_relu(x.float(), w1.float(), b1).to(dt)
    return _conv_k4s2p1_relu(h1.float(), w2.float(), b2).to(dt), h1


def _launch(x, w1, b1, w2, b2, save_hidden: bool):
    """K1 (no hidden) or K1b on CUDA tensors; returns (out, h1 or None)."""
    b, _, t = x.shape
    dt = x.dtype
    bf16 = dt == torch.bfloat16
    require("conv_stem", x, "x", (b, C0, t), dtype=torch.bfloat16 if bf16 else torch.float32)
    require("conv_stem", w1, "w1", (C1, C0, 4), dtype=dt)
    require("conv_stem", b1, "b1", (C1,))
    require("conv_stem", w2, "w2", (C2, C1, 4), dtype=dt)
    require("conv_stem", b2, "b2", (C2,))
    w1t = w1.permute(1, 2, 0).contiguous()  # [c0*4+tap][c1]
    w2t = w2.permute(1, 2, 0).contiguous()  # [c1*4+tap][c2]
    out = torch.empty((b, C2, t // 4), dtype=dt, device=x.device)
    h1 = torch.empty((b, C1, t // 2), dtype=dt, device=x.device) if save_hidden else None
    check("conv_stem", kernel("conv_stem_bf16_fwd" if bf16 else "conv_stem_fwd")(
        x.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(), b2.data_ptr(),
        out.data_ptr(), None if h1 is None else h1.data_ptr(), b, t, stream_of(x)))
    return out, h1


def _check_input(x: torch.Tensor) -> None:
    if x.dim() != 3 or x.shape[-1] < 4:
        raise ValueError(f"conv_stem needs (B, C, T) with T >= 4, got {tuple(x.shape)}")


def conv_stem_save_hidden(x, w1, b1, w2, b2):
    """(B, C0, T) → (out (B, C2, T/4), h1 (B, C1, T/2)): the training forward."""
    _check_input(x)
    if runs_plain("conv_stem", x, w1, b1, w2, b2):
        return conv_stem_ref(x, w1, b1, w2, b2)
    out = _launch(x, w1, b1, w2, b2, save_hidden=True)
    count_launch(conv_stem_save_hidden, x.dtype)
    return out


class _ConvStem(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        out, h1 = conv_stem_save_hidden(x, w1, b1, w2, b2)
        ctx.save_for_backward(x, h1, out, w1, w2)
        return out

    @staticmethod
    def backward(ctx, g):
        x, h1, out, w1, w2 = ctx.saved_tensors
        g2 = torch.where(out > 0, g, 0.0).to(h1.dtype)
        dh1, dw2, db2 = conv_grads(g2, h1, w2, transposed=False, need_input=True)
        dh1 = torch.where(h1 > 0, dh1, 0.0)
        dx, dw1, db1 = conv_grads(dh1, x, w1, transposed=False,
                                  need_input=ctx.needs_input_grad[0])
        return dx, dw1, db1, dw2, db2


def conv_stem(x, w1, b1, w2, b2):
    """(B, C0, T) → (B, C2, floor(T/4)), T >= 4, in x's type (fp32 or bf16),
    differentiable in both."""
    _check_input(x)
    if needs_grad(x, w1, b1, w2, b2):
        return _ConvStem.apply(x, w1, b1, w2, b2)
    if runs_plain("conv_stem", x, w1, b1, w2, b2):
        return conv_stem_ref(x, w1, b1, w2, b2)[0]
    out, _ = _launch(x, w1, b1, w2, b2, save_hidden=False)
    count_launch(conv_stem, x.dtype)
    return out


conv_stem.launches = collections.Counter()
conv_stem_save_hidden.launches = collections.Counter()
