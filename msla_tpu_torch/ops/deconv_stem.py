"""The VQ-VAE decoder stem: convT k4 s2 p1 + ReLU, then convT k4 s2 p1.

Port of msla_tpu/ops/deconv_stem.py. On CUDA tensors the hand-written kernel
``csrc/deconv_stem.cu`` runs the forward: ``deconv_stem`` launches it without
the hidden (K2, which keeps the (B, 64, 2W) hidden out of device memory), and
``deconv_stem_save_hidden`` launches it with the hidden (K2b). On CPU tensors
both run ``deconv_stem_ref``, the plain PyTorch version of the same arithmetic.

Under autograd, ``deconv_stem`` is an ``autograd.Function`` whose forward is
K2b and whose backward is the JAX package's ``_fused_bwd``
(msla_tpu/ops/deconv_stem.py:180-190): the ReLU mask from the saved hidden and
the exact conv-transpose adjoints (cuDNN on the card), with no forward
recompute. The Function is the same on both devices.

The bf16 compute_dtype runs the Pallas kernel's bf16 function
(msla_tpu/ops/deconv_stem.py:35-63): q, w1 and w2 bf16, the biases fp32, the
products summed in fp32, h rounded to bf16 before the second layer (and saved
so by K2b) and a bf16 output. The operand type is q's. Its backward is
``_fused_bwd`` on bf16 operands: the output gradient cast to bf16, the
adjoints in bf16 (``conv_grads``), dh masked by h > 0 and kept bf16, the
biases' gradients summed in fp32.

A stride-2 transposed conv splits into two phases (torch weight (in, out, k)):
  out[2m]   = x[m]·W[..., 1] + x[m-1]·W[..., 3]
  out[2m+1] = x[m]·W[..., 2] + x[m+1]·W[..., 0]
Layout is torch's: q (B, C, W), output (B, C_out, 4W), hidden (B, C1, 2W).

Both kernels run both layers as matrix products on the tensor cores (bf16
products in bf16, fp32 ones in 3xTF32), with the phases stacked into two
operands that their prologues pack from w1 and w2; ``phase_operands`` is the
same packing in plain PyTorch, and ``deconv_stem_phase_ref`` and
``deconv_stem_3xtf32_ref`` the stem written with it as the bf16 and the fp32
kernel compute it, for the tests (no wrapper calls them).

Widths: any C → C1 → 4 with C from 1 to ``MAX_C`` and C1 from 1 to
``MAX_C1`` (num_hidden from 2 to 512, C = num_hidden, C1 = num_hidden // 2,
as the JAX decoder builds them), in fp32 and bf16; ``plan_stem`` picks the
kernel for a width. The tuned kernels of ``csrc/deconv_stem.cu`` take the
widths of configs/hparams_search/optuna.yaml, ``FP32_WIDTHS`` in fp32, all
in 3xTF32: (128, 64), the default config's, and (64, 32) with W1′ whole in a
block; (256, 128), whose W1′ does not fit in a block, with h's channels cut
into quarters over a cluster of 4 blocks, whose partial outputs are added in
block order (``cluster_blocks``); bf16 takes (128, 64) there. Every other
width runs ``csrc/stem_any.cu``'s kernel, C and C1 padded to the mma's k
step (8 in fp32, 16 in bf16) with lanes that add exact zeros, its second
layer as 8 partial sums (``second_layer_chains``). A width past the limits
raises ``ValueError`` naming it on a CUDA tensor; the plain version takes any
width.
"""
from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

from msla_tpu_torch.ops._build import (SMEM_BYTES, check, count_launch, kernel, needs_grad,
                                       require, runs_plain, stream_of)
from msla_tpu_torch.ops.conv_adjoints import conv_grads
from msla_tpu_torch.ops.conv_stem import GRANULE, StemPlan, _align16, _round_up
from msla_tpu_torch.ops.tf32 import product_3xtf32

#: the default widths (the full-width model's): the 3xTF32 and bf16 kernels'
C, C1, C_OUT = 128, 64, 4
#: the (C, C1) the tuned fp32 kernels are compiled for
FP32_WIDTHS = ((64, 32), (C, C1), (256, 128))
#: the largest widths any kernel takes: num_hidden 512's
MAX_C, MAX_C1 = 512, 256
#: the any-width kernel's tiles of q's positions, the largest whose block fits first
ANY_TILES = (64, 32, 16)
ANY_WARPS = 8         # its warps, each one partial sum of the second layer


def any_smem_bytes(c: int, c1: int, tile: int, dtype: torch.dtype) -> int:
    """A block of ``csrc/stem_any.cu``'s decoder kernel, as its
    ``stem_any_smem_bytes`` reports it: q's tile [tile + 9][CP + pad] (or the
    8 warps' partial sums [8][16][tile] fp32 over it, if larger) and hE, hO
    [tile + 8][C1P + pad] each (pad 4 floats, or 8 bf16)."""
    es, pad = (4, 4) if dtype == torch.float32 else (2, 8)
    cp, c1p = _round_up(c, GRANULE[dtype]), _round_up(c1, GRANULE[dtype])
    qs = max((tile + 9) * (cp + pad) * es, ANY_WARPS * 16 * tile * 4)
    return _align16(qs) + 2 * _align16((tile + 8) * (c1p + pad) * es)


def plan_stem(c: int, c1: int, dtype: torch.dtype = torch.float32) -> StemPlan:
    """The kernel that runs the stem c → c1 → 4 on ``dtype`` operands: a
    tuned one at its widths, else the any-width kernel at the largest tile
    whose block fits. Raises ``ValueError`` past MAX_C or MAX_C1."""
    if dtype not in GRANULE:
        raise ValueError(f"deconv_stem: operands must be float32 or bfloat16, got {dtype}")
    if not (1 <= c <= MAX_C and 1 <= c1 <= MAX_C1):
        raise ValueError(f"deconv_stem: widths (C, C1) = ({c}, {c1}) outside the kernels' "
                         f"limits, C from 1 to {MAX_C} and C1 from 1 to {MAX_C1}")
    bf16 = dtype == torch.bfloat16
    if bf16 and (c, c1) == (C, C1):
        return StemPlan("deconv_stem_bf16_fwd", "bf16", (c, c1), 120, None, 0.0)
    if not bf16 and (c, c1) in FP32_WIDTHS:
        cluster = (c, c1) == (256, 128)
        return StemPlan("deconv_stem_fwd", "3xTF32" + " cluster" * cluster, (c, c1), 60, None,
                        0.0)
    cp, c1p = _round_up(c, GRANULE[dtype]), _round_up(c1, GRANULE[dtype])
    tile = next(t for t in ANY_TILES if any_smem_bytes(c, c1, t, dtype) <= SMEM_BYTES)
    real = 4 * c * c1 + 64 * c1                 # the two layers' products a position of q
    return StemPlan("deconv_stem_any_fwd", "any width" + " bf16" * bf16, (cp, c1p), tile,
                    any_smem_bytes(c, c1, tile, dtype), 1 - real / (4 * cp * c1p + 64 * c1p))


def _convt_k4s2p1(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    xp = F.pad(x, (1, 1))                             # x[m-1], x[m], x[m+1]
    prev, cur, nxt = xp[..., :-2], xp[..., 1:-1], xp[..., 2:]
    tap = lambda v, t: torch.einsum("bcw,co->bow", v, w[..., t])
    even = tap(cur, 1) + tap(prev, 3)
    odd = tap(cur, 2) + tap(nxt, 0)
    out = torch.stack([even, odd], dim=-1).flatten(-2)  # interleave the phases
    return out + b[:, None]


def deconv_stem_ref(q, w1, b1, w2, b2):
    """Plain version: both transposed convs as explicit phase sums, in q's
    type: for bf16 the sums run in fp32 on the exact products and h and the
    output are rounded to bf16. Returns (out, h)."""
    dt = q.dtype
    h = torch.relu(_convt_k4s2p1(q.float(), w1.float(), b1)).to(dt)
    return _convt_k4s2p1(h.float(), w2.float(), b2).to(dt), h


#: the tap of w2 that multiplies row set g of the packed second layer
#: (0: h[2l], 1: h[2l-1], 2: h[2l+1], 3: h[2l+2]) into out[4l + j]; None: zero
_W2_TAPS = ((1, 2, 3, None), (3, None, None, None), (None, 0, 1, 2), (None, None, None, 0))


def phase_operands(w1: torch.Tensor, w2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16 kernel's stacked phase operands, from torch-layout weights
    w1 (C, C1, 4) and w2 (C1, C_out, 4):
    W1' (2·C1, 2·C): row o is he channel o, row C1 + o ho channel o; column
    c multiplies q[r-1] channel c, column C + c q[r] channel c, so that
    W1'·[q[r-1]; q[r]] = [he[r]; ho[r-1]] (he = h[2r], ho[r-1] = h[2r-1]);
    W2' (4·C_out, 4·C1): row 4o + j gives out[4l + j] of channel o from
    [h[2l]; h[2l-1]; h[2l+1]; h[2l+2]] (zero blocks included)."""
    c, c1, c_out = w1.shape[0], w1.shape[1], w2.shape[1]
    t1 = lambda tap: w1[..., tap].T                     # (C1, C)
    w1p = torch.cat([torch.cat([t1(3), t1(1)], 1), torch.cat([t1(2), t1(0)], 1)], 0)
    w2p = w2.new_zeros((4 * c_out, 4 * c1))
    for g, taps in enumerate(_W2_TAPS):
        for j, tap in enumerate(taps):
            if tap is not None:
                w2p[j::4, g * c1:(g + 1) * c1] = w2[..., tap].T  # rows 4o + j
    return w1p, w2p


def _deconv_by_phases(q, w1, b1, w2, b2, layer1, layer2):
    """The stem from ``phase_operands``: [he[r]; ho[r-1]] = ``layer1`` of W1'
    and [q[r-1]; q[r]] (r = 0 .. W), + b1, ReLU, rounded to q's type with h's
    rows outside [0, 2W) zero; the packed output = ``layer2`` of W2' and
    [h[2l]; h[2l-1]; h[2l+1]; h[2l+2]], + b2, rounded to q's type. Returns
    (out, h) as ``deconv_stem_ref``."""
    dt = q.dtype
    (b, _, w), c1, c_out = q.shape, w1.shape[1], w2.shape[1]
    w1p, w2p = (t.float() for t in phase_operands(w1, w2))
    qp = F.pad(q.float(), (1, 1))                        # q[-1] .. q[W]
    cols = torch.cat([qp[..., :-1], qp[..., 1:]], 1)     # [q[r-1]; q[r]], r = 0 .. W
    hr = torch.relu(layer1(w1p, cols) + b1.repeat(2)[:, None])
    he, ho = hr[:, :c1].clone(), hr[:, c1:].clone()      # he[r] = h[2r], ho[r] = h[2r-1]
    he[..., w], ho[..., 0] = 0.0, 0.0                    # h[2W] and h[-1]: padding
    he, ho = he.to(dt).float(), ho.to(dt).float()
    rows = torch.cat([he[..., :-1], ho[..., :-1], ho[..., 1:], he[..., 1:]], 1)
    packed = layer2(w2p, rows) + b2.repeat_interleave(4)[:, None]
    out = packed.view(b, c_out, 4, w).transpose(2, 3).flatten(2)  # out[o][4l + j]: row 4o + j
    h = torch.stack([he[..., :-1], ho[..., 1:]], -1).flatten(2)   # h[2m], h[2m+1]
    return out.to(dt), h.to(dt)


def deconv_stem_phase_ref(q, w1, b1, w2, b2):
    """The stem written as the bf16 kernel computes it (``_deconv_by_phases``):
    both layers as products in fp32 of q's type's values. Returns (out, h) as
    ``deconv_stem_ref``."""
    mm = lambda w, a: torch.einsum("nk,bkl->bnl", w, a)
    return _deconv_by_phases(q, w1, b1, w2, b2, mm, mm)


def cluster_blocks(c: int, c1: int) -> int:
    """The blocks the fp32 kernel cuts h's channels over: 4, a cluster, at
    (256, 128), where the first layer runs as two chains (W1′'s q[r-1]
    columns, then its q[r] ones, each over q's channels in order) and each
    block's partial output of the second layer is added in block order; one
    elsewhere."""
    return 4 if (c, c1) == (256, 128) else 1


def second_layer_chains(c: int, c1: int) -> int:
    """The partial sums the fp32 kernel runs the second layer's depth as,
    added in fp32: two row sets on each of ``cluster_blocks`` blocks at the
    tuned widths; elsewhere the any-width kernel's warps, one a run of the
    depth's k8 steps (fewer where the depth has fewer steps)."""
    if (c, c1) in FP32_WIDTHS:
        return 2 * cluster_blocks(c, c1)
    return min(ANY_WARPS, 4 * _round_up(c1, GRANULE[torch.float32]) // 8)


def _layer1_order(c: int) -> torch.Tensor:
    """W1''s columns in the order the fp32 kernel's first layer takes them: q's
    channels [0, c/2) at r-1 and at r, then [c/2, c) at r-1 and at r (the two
    halves of q's tile arrive apart)."""
    half = torch.arange(c // 2)
    return torch.cat([half, c + half, c // 2 + half, c + c // 2 + half])


def deconv_stem_3xtf32_ref(q, w1, b1, w2, b2):
    """The stem as the fp32 kernel computes it (``_deconv_by_phases`` on fp32
    q), both layers in 3xTF32 (``product_3xtf32``) with the kernel's operands:
    the first W1' by the columns over its 2·C in ``_layer1_order``, one
    accumulator (on a cluster, ``cluster_blocks``: the q[r-1] columns and the
    q[r] ones as two, added in fp32); the second the rows by W2'ᵀ for each
    block's group of h's channels, as two accumulators over the row sets
    h[2l], h[2l-1] and h[2l+1], h[2l+2] of the group's channels, added in
    fp32; the groups' sums added in order before b2. Returns (out, h) as
    ``deconv_stem_ref``."""
    groups = cluster_blocks(*widths_of(w1))

    def layer1(w, cols):
        if groups > 1:
            c = cols.shape[1] // 2
            return product_3xtf32(w[:, :c], cols[:, :c]) + product_3xtf32(w[:, c:], cols[:, c:])
        order = _layer1_order(cols.shape[1] // 2).to(cols.device)
        return product_3xtf32(w[:, order], cols[:, order])

    def layer2(w, rows):
        c1 = rows.shape[1] // 4
        n = c1 // groups

        def chain(group, sets):  # the group's channels of each row set, in order
            k = torch.cat([torch.arange(s * c1 + group * n, s * c1 + (group + 1) * n)
                           for s in sets]).to(rows.device)
            return product_3xtf32(rows[:, k].transpose(1, 2), w[:, k].T)

        parts = [chain(group, (0, 1)) + chain(group, (2, 3)) for group in range(groups)]
        return sum(parts[1:], parts[0]).transpose(1, 2)

    return _deconv_by_phases(q, w1, b1, w2, b2, layer1, layer2)


def widths_of(w1: torch.Tensor) -> tuple[int, int]:
    """(C, C1) of a torch-layout ConvTranspose1d weight w1 (C, C1, 4)."""
    return w1.shape[0], w1.shape[1]


def _launch(q, w1, b1, w2, b2, save_hidden: bool):
    """K2 (no hidden) or K2b on CUDA tensors; returns (out, h or None)."""
    b, _, w = q.shape
    dt = q.dtype
    bf16 = dt == torch.bfloat16
    c, c1 = widths_of(w1)
    plan = plan_stem(c, c1, dt)
    require("deconv_stem", q, "q", (b, c, w), dtype=torch.bfloat16 if bf16 else torch.float32)
    require("deconv_stem", w1, "w1", (c, c1, 4), dtype=dt)
    require("deconv_stem", b1, "b1", (c1,))
    require("deconv_stem", w2, "w2", (c1, C_OUT, 4), dtype=dt)
    require("deconv_stem", b2, "b2", (C_OUT,))
    out = torch.empty((b, C_OUT, 4 * w), dtype=dt, device=q.device)
    h = torch.empty((b, c1, 2 * w), dtype=dt, device=q.device) if save_hidden else None
    args = (q.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), None if h is None else h.data_ptr(), b, w)
    if plan.symbol == "deconv_stem_any_fwd":
        status = kernel(plan.symbol)(int(bf16), *args, c, c1, plan.tile, stream_of(q))
    elif bf16:
        status = kernel(plan.symbol)(*args, stream_of(q))
    else:
        status = kernel(plan.symbol)(*args, c, c1, stream_of(q))
    check("deconv_stem", status)
    return out, h


def _check_input(q: torch.Tensor) -> None:
    if q.dim() != 3:
        raise ValueError(f"deconv_stem needs (B, C, W), got {tuple(q.shape)}")


def deconv_stem_save_hidden(q, w1, b1, w2, b2):
    """(B, C, W) → (out (B, C_out, 4W), h (B, C1, 2W)): the training forward."""
    _check_input(q)
    if runs_plain("deconv_stem", q, w1, b1, w2, b2):
        return deconv_stem_ref(q, w1, b1, w2, b2)
    out = _launch(q, w1, b1, w2, b2, save_hidden=True)
    count_launch(deconv_stem_save_hidden, q.dtype, widths_of(w1))
    return out


class _DeconvStem(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, w1, b1, w2, b2):
        out, h = deconv_stem_save_hidden(q, w1, b1, w2, b2)
        ctx.save_for_backward(q, h, w1, w2)
        return out

    @staticmethod
    def backward(ctx, g):
        q, h, w1, w2 = ctx.saved_tensors
        dh, dw2, db2 = conv_grads(g.to(h.dtype), h, w2, transposed=True, need_input=True)
        dh = torch.where(h > 0, dh, 0.0)
        dq, dw1, db1 = conv_grads(dh, q, w1, transposed=True,
                                  need_input=ctx.needs_input_grad[0])
        return dq, dw1, db1, dw2, db2


def deconv_stem(q, w1, b1, w2, b2):
    """(B, C, W) → (B, C_out, 4W) in q's type (fp32 or bf16); ReLU after the
    first layer only. Differentiable in both types."""
    _check_input(q)
    if needs_grad(q, w1, b1, w2, b2):
        return _DeconvStem.apply(q, w1, b1, w2, b2)
    if runs_plain("deconv_stem", q, w1, b1, w2, b2):
        return deconv_stem_ref(q, w1, b1, w2, b2)[0]
    out, _ = _launch(q, w1, b1, w2, b2, save_hidden=False)
    count_launch(deconv_stem, q.dtype, widths_of(w1))
    return out


for _wrapper in (deconv_stem, deconv_stem_save_hidden):
    _wrapper.launches, _wrapper.widths = collections.Counter(), collections.Counter()
