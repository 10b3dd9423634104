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

Both kernels run both convs as matrix products on the tensor cores (bf16
products in bf16, fp32 ones in 3xTF32): conv1 on each h1 row's packed window
of 4 samples x 4 channels, conv2 on the even and odd rows of h1 at shifts 0
and 1, with operands their prologues pack from w1 and w2. ``stem_operands``
is the same packing in plain PyTorch, and ``conv_stem_phase_ref`` and
``conv_stem_3xtf32_ref`` the stem written with it as the bf16 and the fp32
kernel compute it, for the tests (no wrapper calls them).

Widths: any 4 → C1 → C2 with C1 from 1 to ``MAX_C1`` and C2 from 1 to
``MAX_C2`` (num_hidden from 2 to 512, C2 = num_hidden, C1 = num_hidden // 2,
as the JAX encoder builds them), in fp32 and bf16; ``plan_stem`` picks the
kernel for a width. The tuned kernels of ``csrc/conv_stem.cu`` take the
widths of configs/hparams_search/optuna.yaml, ``FP32_WIDTHS`` in fp32, all
in 3xTF32: (64, 128), the default config's, and (32, 64) with W2′ whole in a
block; (128, 256), whose W2′ does not fit in a block, with W2′ cut into
groups of 64 output channels and conv2 run as one partial sum a tap
(``conv2_chains``); bf16 takes (64, 128) there. Every other width runs
``csrc/stem_any.cu``'s kernel, its widths padded to the mma's granule (C1 to
8 in fp32 and 16 in bf16, C2 to 16) with lanes that add exact zeros, conv2
one chain in fp32. A width past the limits raises ``ValueError`` naming it
on a CUDA tensor; the plain version takes any width.
"""
from __future__ import annotations

import collections
from typing import NamedTuple

import torch
import torch.nn.functional as F

from msla_tpu_torch.ops._build import (SMEM_BYTES, check, count_launch, kernel, needs_grad,
                                       require, runs_plain, stream_of)
from msla_tpu_torch.ops.conv_adjoints import conv_grads
from msla_tpu_torch.ops.tf32 import product_3xtf32

#: the default widths (the full-width model's): the 3xTF32 and bf16 kernels'
C0, C1, C2 = 4, 64, 128
#: the (C1, C2) the tuned fp32 kernels are compiled for
FP32_WIDTHS = ((32, 64), (C1, C2), (128, 256))
#: the largest widths any kernel takes: num_hidden 512's
MAX_C1, MAX_C2 = 256, 512
#: the any-width kernel's granules: C1 (a depth) by operand type, C2 (m16 rows)
GRANULE = {torch.float32: 8, torch.bfloat16: 16}
M_GRANULE = 16
#: its tiles of output positions, the largest whose block fits first
ANY_TILES = (128, 64, 32)


class StemPlan(NamedTuple):
    """How a stem runs at its widths: the C entry point, the design, the
    widths as the kernel runs them, its tile of positions, a block's dynamic
    shared memory (None for a tuned kernel: its source's ``*_smem_bytes``
    reports it) and the share of its products on padded lanes."""
    symbol: str
    design: str
    padded: tuple[int, int]
    tile: int
    smem: int | None
    padded_share: float


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _align16(v: int) -> int:
    return _round_up(v, 16)


def any_smem_bytes(c1: int, tile: int, dtype: torch.dtype) -> int:
    """A block of ``csrc/stem_any.cu``'s encoder kernel, as its
    ``stem_any_smem_bytes`` reports it: x's window [4][4·tile + 16] and hE,
    hO [tile + 2][C1P + pad] each (pad 4 floats, or 8 bf16)."""
    es, pad = (4, 4) if dtype == torch.float32 else (2, 8)
    c1p = _round_up(c1, GRANULE[dtype])
    return _align16(C0 * (4 * tile + 16) * es) + 2 * _align16((tile + 2) * (c1p + pad) * es)


def plan_stem(c1: int, c2: int, dtype: torch.dtype = torch.float32) -> StemPlan:
    """The kernel that runs the stem 4 → c1 → c2 on ``dtype`` operands: a
    tuned one at its widths, else the any-width kernel at the largest tile
    whose block fits. Raises ``ValueError`` past MAX_C1 or MAX_C2."""
    if dtype not in GRANULE:
        raise ValueError(f"conv_stem: operands must be float32 or bfloat16, got {dtype}")
    if not (1 <= c1 <= MAX_C1 and 1 <= c2 <= MAX_C2):
        raise ValueError(f"conv_stem: widths (C1, C2) = ({c1}, {c2}) outside the kernels' "
                         f"limits, C1 from 1 to {MAX_C1} and C2 from 1 to {MAX_C2}")
    bf16 = dtype == torch.bfloat16
    if bf16 and (c1, c2) == (C1, C2):
        return StemPlan("conv_stem_bf16_fwd", "bf16", (c1, c2), 128, None, 0.0)
    if not bf16 and (c1, c2) in FP32_WIDTHS:
        groups = (c1, c2) == (128, 256)
        return StemPlan("conv_stem_fwd", "3xTF32" + " groups" * groups, (c1, c2),
                        64 if groups else 128, None, 0.0)
    c1p, c2p = _round_up(c1, GRANULE[dtype]), _round_up(c2, M_GRANULE)
    tile = next(t for t in ANY_TILES if any_smem_bytes(c1, t, dtype) <= SMEM_BYTES)
    real = 4 * c1 * c2 + 2 * 16 * c1            # conv2's and conv1's products a position
    return StemPlan("conv_stem_any_fwd", "any width" + " bf16" * bf16, (c1p, c2p), tile,
                    any_smem_bytes(c1, tile, dtype), 1 - real / (4 * c1p * c2p + 2 * 16 * c1p))


def conv2_chains(c1: int, c2: int) -> int:
    """The partial sums the fp32 kernels run conv2's depth as, added in
    order: one a tap at (128, 256), where a block holds a group of W2′'s rows
    and its warps take the taps; one elsewhere (the any-width kernel runs one
    chain)."""
    return 4 if (c1, c2) == (128, 256) else 1


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


def stem_operands(w1: torch.Tensor, w2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16 kernel's packed operands, from torch-layout weights w1 (C1, C0, 4)
    and w2 (C2, C1, 4):
    W1 (C1, 4·C0): W1[c1][c0·4 + tap] = w1[c1][c0][tap], so that h1[j] =
    relu(W1·P[j] + b1) where P[j][c0·4 + tap] = x[c0][2j − 1 + tap] is row j's
    window (the even and odd rows alike);
    W2' (C2, 4·C1): W2'[c2][tap·C1 + c1] = w2[c2][c1][tap], so that out[q] =
    relu(W2'·[h1[2q − 1]; h1[2q]; h1[2q + 1]; h1[2q + 2]] + b2)."""
    return w1.reshape(w1.shape[0], -1), w2.permute(0, 2, 1).reshape(w2.shape[0], -1)


def _stem_by_phases(x, w1, b1, w2, b2, conv1, conv2):
    """The stem from ``stem_operands``: each h1 row j = -1 .. 2·(T/4) (the
    rows conv2 reads, halo included) as ``conv1`` of its packed window and W1,
    + b1, ReLU, zero outside [0, T/2) and rounded to x's type; then ``conv2``
    of the odd rows hO[i] = h1[2i − 1] and even rows hE[i] = h1[2i] at shifts
    0 and 1 and W2', + b2, ReLU, rounded to x's type. Returns (out, h1)."""
    dt = x.dtype
    t = x.shape[-1]
    half, w2_len = t // 2, t // 4
    w1p, w2p = (w.float() for w in stem_operands(w1, w2))
    xp = F.pad(x.float(), (3, 6))                        # x[-3] .. x[T + 5]
    win = xp.unfold(2, 4, 2)[:, :, :2 * w2_len + 2]      # window m: x[2m - 3 ..], row j = m - 1
    p = win.permute(0, 2, 1, 3).flatten(2)               # P[j][c0·4 + tap]
    rows = torch.relu(conv1(p, w1p) + b1)                # (B, rows, C1)
    j = torch.arange(-1, 2 * w2_len + 1, device=x.device)
    rows = torch.where(((j >= 0) & (j < half))[:, None], rows, 0.0).to(dt).float()
    h_o, h_e = rows[:, 0::2], rows[:, 1::2]             # hO[i] = h1[2i - 1], hE[i] = h1[2i]
    taps = torch.cat([h_o[:, :-1], h_e[:, :-1], h_o[:, 1:], h_e[:, 1:]], 2)
    out = torch.relu(conv2(taps, w2p) + b2).transpose(1, 2)
    return out.to(dt), rows[:, 1:half + 1].transpose(1, 2).to(dt)


def conv_stem_phase_ref(x, w1, b1, w2, b2):
    """The stem as the bf16 kernel computes it (``_stem_by_phases``): the
    products in fp32 of x's type's values, conv2 as two partial sums, taps 0-1
    and taps 2-3, added in fp32. Returns (out, h1) as ``conv_stem_ref``."""
    c = 2 * w1.shape[0]                                  # taps 0-1, then taps 2-3
    return _stem_by_phases(x, w1, b1, w2, b2, lambda p, w: p @ w.T,
                           lambda a, w: a[..., :c] @ w[:, :c].T + a[..., c:] @ w[:, c:].T)


def conv_stem_3xtf32_ref(x, w1, b1, w2, b2):
    """The stem as the fp32 kernel computes it (``_stem_by_phases`` on fp32
    x): both convs in 3xTF32 (``product_3xtf32``) with the kernel's operands,
    conv1 the windows by W1 over its 16 packed columns, one accumulator;
    conv2 W2' by the rows over its 4·C1 in their order, as ``conv2_chains``
    accumulators over equal runs of the depth (the taps at (128, 256)),
    added in order. Returns (out, h1) as ``conv_stem_ref``."""
    chains = conv2_chains(*widths_of(w1, w2))

    def conv2(a, w):
        k = w.shape[1] // chains
        parts = [product_3xtf32(w[:, i * k:(i + 1) * k],
                                a[..., i * k:(i + 1) * k].transpose(1, 2)).transpose(1, 2)
                 for i in range(chains)]
        return sum(parts[1:], parts[0])

    return _stem_by_phases(x, w1, b1, w2, b2, lambda p, w: product_3xtf32(p, w.T), conv2)


def widths_of(w1: torch.Tensor, w2: torch.Tensor) -> tuple[int, int]:
    """(C1, C2) of torch-layout weights w1 (C1, C0, 4) and w2 (C2, C1, 4)."""
    return w1.shape[0], w2.shape[0]


def _launch(x, w1, b1, w2, b2, save_hidden: bool):
    """K1 (no hidden) or K1b on CUDA tensors; returns (out, h1 or None)."""
    b, _, t = x.shape
    dt = x.dtype
    bf16 = dt == torch.bfloat16
    c1, c2 = widths_of(w1, w2)
    plan = plan_stem(c1, c2, dt)
    require("conv_stem", x, "x", (b, C0, t), dtype=torch.bfloat16 if bf16 else torch.float32)
    require("conv_stem", w1, "w1", (c1, C0, 4), dtype=dt)
    require("conv_stem", b1, "b1", (c1,))
    require("conv_stem", w2, "w2", (c2, c1, 4), dtype=dt)
    require("conv_stem", b2, "b2", (c2,))
    w1t = w1.permute(1, 2, 0).contiguous()  # [c0*4+tap][c1]
    w2t = w2.permute(1, 2, 0).contiguous()  # [c1*4+tap][c2]
    out = torch.empty((b, c2, t // 4), dtype=dt, device=x.device)
    h1 = torch.empty((b, c1, t // 2), dtype=dt, device=x.device) if save_hidden else None
    args = (x.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(), b2.data_ptr(),
            out.data_ptr(), None if h1 is None else h1.data_ptr(), b, t)
    if plan.symbol == "conv_stem_any_fwd":
        status = kernel(plan.symbol)(int(bf16), *args, c1, c2, plan.tile, stream_of(x))
    elif bf16:
        status = kernel(plan.symbol)(*args, stream_of(x))
    else:
        status = kernel(plan.symbol)(*args, c1, c2, stream_of(x))
    check("conv_stem", status)
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
    count_launch(conv_stem_save_hidden, x.dtype, widths_of(w1, w2))
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
    count_launch(conv_stem, x.dtype, widths_of(w1, w2))
    return out


for _wrapper in (conv_stem, conv_stem_save_hidden):
    _wrapper.launches, _wrapper.widths = collections.Counter(), collections.Counter()
