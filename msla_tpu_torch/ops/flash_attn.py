"""Attention with a key-padding mask (port of msla_tpu/ops/flash_attn.py).

softmax(q·kᵀ·sm_scale + (1 − kv_mask)·(−1e9))·v in fp32, with its gradient.
On CUDA tensors ``flash_attn`` launches hand-written kernels, which keep the
(Sq, Sk) scores out of device memory with an online softmax; on CPU tensors
it runs ``attention_ref``, the JAX package's XLA chain (``_xla_attention``):
scaled scores plus the mask bias, an fp32 softmax, then ``@ v``.

Both follow that chain on every row, padded query rows included, and a
sequence whose keys are all padding gets the mean of v (its scores all round
to −1e9). The JAX TPU kernel differs at padded query rows (it masks with
segment ids); the port does not.

Shapes: q (B, Sq, H, D), k and v (B, Sk, H, D), the projections' layout, with
Sq and Sk each >= 1 and free of each other, and an optional (B, Sk) mask.
``plan_attention`` picks the kernel for a head width D: the tuned
``csrc/flash_attn.cu`` at D = 64 (``TUNED_D``), ``csrc/flash_any.cu`` at any
other D up to ``MAX_D``; past it, and for any shape no kernel takes, a
``ValueError`` that names it. The wrapper never falls back.

Under autograd (``needs_grad``) ``flash_attn`` is ``_FlashAttn``, an
``autograd.Function``, on both devices: its forward also writes each query
row's log-sum-exp, and its backward (``csrc/flash_bwd.cu`` on the card,
``attention_bwd_ref`` on the CPU) recomputes the probabilities from it, as
FA2 and the JAX TPU kernel's backward (``_flash_attention_bwd_dkv``,
``_flash_attention_bwd_dq``) do: P = exp(s − lse), Dᵢ = Σ dO∘O,
dS = P∘(dP − Dᵢ)·sm_scale, dQ = dS·K, dK = dSᵀ·Q, dV = Pᵀ·dO.

The saved log-sum-exp is taken less each sequence's largest bias
(``attention_shift``: 0 unless every key is padding, then −1e9): −1e9 +
log Sk would round to −1e9 in fp32 and lose the uniform softmax such a
sequence has, while the shifted one keeps log Sk.

With bf16 q, k and v (the bf16 compute_dtype) the forward is
``_xla_attention``'s on bf16 operands: fp32 scores of the exact products, an
fp32 softmax, the probabilities rounded to bf16 before ``@ v``, which sums in
fp32, and an fp32 output. The kernels round the unnormalised p = exp(s − m)
instead, as JAX's TPU kernel does, so the two part by up to 2⁻⁸ of
Σₖ pₖ|vₖ|. The bf16 backward rounds where JAX's TPU kernel does: dO to
bf16 (JAX's output is bf16 there), P to bf16 before Pᵀ·dO, dS·sm_scale to
bf16 before its products, fp32 sums, and dQ, dK, dV in q's type.
``attention_3xtf32_ref`` and ``attention_bwd_3xtf32_ref`` emulate the fp32
kernels' 3xTF32 products for the tests; no wrapper calls them.
"""
from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple

import torch

from msla_tpu_torch.ops._build import (SMEM_BYTES, aligned, check, count_launch, kernel,
                                       needs_grad, require, runs_plain, stream_of)
from msla_tpu_torch.ops.tf32 import product_3xtf32

#: the head width of the tuned forward (bert-base: 768 / 12)
TUNED_D = 64
#: the widest head any kernel takes
MAX_D = 256
#: the any-width kernels' k step by operand type: D is padded to it with zeros
GRANULE = {torch.float32: 8, torch.bfloat16: 16}
#: shared-memory rows are padded by this many elements (fragment loads on 32 banks)
_ROW_PAD = {torch.float32: 4, torch.bfloat16: 8}
#: query rows (keys, for dK and dV) a block owns: 4 warps of 16
BLOCK_ROWS = 64
#: (the widest padded D of a class, the forward's keys a step, the backward's
#: keys (dQ) or queries (dK, dV) a step): fewer where the accumulators grow.
#: ``csrc/flash_tiles.cuh``'s ``Class<>`` is the kernels' copy; the sources'
#: ``*_smem_bytes`` must equal ``any_smem_bytes`` (chip_smoke.py phase 33)
_CLASSES = ((32, 64, 64), (64, 64, 64), (128, 64, 32), (256, 32, 16))


class AttentionPlan(NamedTuple):
    """How attention runs at a head width: the forward's C entry point and
    design, D as the any-width kernels run it (the backward always), the
    widest padded D of its class (the accumulators' columns), the forward's
    keys a step, the backward's keys a step of dQ and queries a step of
    dK/dV, and each block's dynamic shared memory in bytes (``fwd`` None for
    the tuned kernel)."""
    symbol: str
    design: str
    padded: int
    widest: int
    fwd_tile: int
    bwd_tile: int
    smem: dict


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def any_smem_bytes(d: int, dtype: torch.dtype, part: str) -> int:
    """A block's shared memory in ``csrc/flash_any.cu`` (part "fwd") or
    ``csrc/flash_bwd.cu`` ("dq", "dkv"), as their ``*_smem_bytes`` report it:
    rows of Dp + pad elements; fwd Q [64] and K, V [BK] rows, then BK mask
    values; dq Q, dO [64] and K, V [BK] rows, then BK mask values and 64 lse
    and 64 Dᵢ; dkv K, V [64] and Q, dO [BQ] rows, then 64 mask values, BQ lse
    and BQ Dᵢ."""
    dp = _round_up(d, GRANULE[dtype])
    _, fwd_tile, bwd_tile = next(c for c in _CLASSES if dp <= c[0])
    row = (dp + _ROW_PAD[dtype]) * (2 if dtype == torch.bfloat16 else 4)
    if part == "fwd":
        return (BLOCK_ROWS + 2 * fwd_tile) * row + 4 * fwd_tile
    if part == "dq":
        return (2 * BLOCK_ROWS + 2 * bwd_tile) * row + 4 * (bwd_tile + 2 * BLOCK_ROWS)
    return (2 * BLOCK_ROWS + 2 * bwd_tile) * row + 4 * (BLOCK_ROWS + 2 * bwd_tile)


def plan_attention(d: int, dtype: torch.dtype = torch.float32, s_q: int = 1,
                   s_k: int = 1) -> AttentionPlan:
    """The kernels that run attention at head width d on ``dtype`` operands
    over Sq queries and Sk keys: the tuned forward at D = 64, the any-width
    forward elsewhere up to MAX_D; the backward's two kernels at every D.
    Raises ``ValueError`` past MAX_D, at a length below 1 or on another
    operand type."""
    if dtype not in GRANULE:
        raise ValueError(f"flash_attn: q, k, v must be float32 or bfloat16, got {dtype}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"flash_attn: head width D={d} outside the kernels' limit, "
                         f"D from 1 to {MAX_D}")
    if s_q < 1 or s_k < 1:
        raise ValueError(f"flash_attn: lengths Sq={s_q}, Sk={s_k}; each must be at least 1")
    dp = _round_up(d, GRANULE[dtype])
    widest, fwd_tile, bwd_tile = next(c for c in _CLASSES if dp <= c[0])
    smem = {part: any_smem_bytes(d, dtype, part) for part in ("fwd", "dq", "dkv")}
    assert max(smem.values()) <= SMEM_BYTES
    bf16 = " bf16" if dtype == torch.bfloat16 else ""
    if d == TUNED_D:
        return AttentionPlan("flash_attn_bf16_fwd" if bf16 else "flash_attn_fwd", "tuned" + bf16,
                             dp, widest, 64, bwd_tile, {**smem, "fwd": None})
    return AttentionPlan("flash_any_fwd", "any width" + bf16, dp, widest, fwd_tile, bwd_tile,
                         smem)


def attention_shift(kv_mask: torch.Tensor | None, batch: int,
                    device=None) -> torch.Tensor:
    """Each sequence's largest bias, (1 − max_k kv_mask)·(−1e9), (B,) fp32: 0
    (−0) unless every key is padding. The saved log-sum-exp is taken less it.
    The bias is monotone in the mask, so this is the largest of the biases
    the kernels add, bit for bit."""
    if kv_mask is None:
        return torch.zeros((batch,), dtype=torch.float32, device=device)
    return (1.0 - kv_mask.to(torch.float32).amax(dim=1)) * -1e9


def _scores(q: torch.Tensor, k: torch.Tensor, kv_mask: torch.Tensor | None,
            sm_scale: float, product=None) -> torch.Tensor:
    """fp32 (B, H, Sq, Sk) scores of (B, H, S, D) q, k: the products scaled,
    rounded, plus the mask's bias, rounded."""
    if product is None:
        scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    else:
        scores = product(q, k.transpose(-1, -2))
    scores = scores * sm_scale
    if kv_mask is not None:
        scores = scores + (1.0 - kv_mask[:, None, None, :].to(torch.float32)) * -1e9
    return scores


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_mask: torch.Tensor | None, sm_scale: float) -> torch.Tensor:
    """Plain version on (B, H, Sq, D) q and (B, H, Sk, D) k, v, fp32 or bf16;
    fp32 out."""
    weights = torch.softmax(_scores(q, k, kv_mask, sm_scale), dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", weights.float(), v.float())


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, kv_mask: torch.Tensor | None,
                      sm_scale: float) -> torch.Tensor:
    """Each query row's log-sum-exp of its scores less ``attention_shift``,
    (B, H, Sq) fp32: what the forward saves for the backward."""
    shift = attention_shift(kv_mask, q.shape[0], q.device)[:, None, None, None]
    return torch.logsumexp(_scores(q, k, kv_mask, sm_scale) - shift, dim=-1)


def _probabilities(scores, kv_mask, lse):
    shift = attention_shift(kv_mask, scores.shape[0], scores.device)[:, None, None, None]
    return torch.exp((scores - shift) - lse[..., None])


def _bwd(q, k, v, kv_mask, sm_scale, out, lse, d_out, product):
    """The backward by FA2's recompute formulas on (B, H, S, D) tensors, its
    products ``product`` (None: plain fp32). bf16 q rounds where the bf16
    kernels do: dO, then P before Pᵀ·dO and dS·sm_scale before dS·K and
    dSᵀ·Q; the sums are fp32."""
    mm = torch.matmul if product is None else product
    dt = q.dtype
    do = d_out.to(dt).float()
    p = _probabilities(_scores(q, k, kv_mask, sm_scale, product), kv_mask, lse)
    delta = (do * out).sum(dim=-1, keepdim=True)
    ds = p * (mm(do, v.float().transpose(-1, -2)) - delta) * sm_scale
    p, ds = p.to(dt).float(), ds.to(dt).float()
    dv = mm(p.transpose(-1, -2), do)
    return mm(ds, k.float()).to(dt), mm(ds.transpose(-1, -2), q.float()).to(dt), dv.to(dt)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kv_mask: torch.Tensor | None, sm_scale: float, out: torch.Tensor,
                      lse: torch.Tensor, d_out: torch.Tensor):
    """Plain backward on (B, H, Sq, D) q, out, d_out, (B, H, Sk, D) k, v and
    the forward's (B, H, Sq) ``lse`` → (dq, dk, dv) in q's type."""
    return _bwd(q, k, v, kv_mask, sm_scale, out, lse, d_out, None)


def attention_3xtf32_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_mask: torch.Tensor | None, sm_scale: float) -> torch.Tensor:
    """The fp32 kernels' arithmetic on (B, H, Sq, D) q and (B, H, Sk, D) k, v,
    fp32, any D and Sk, emulated: Q·Kᵀ and P·V in 3xTF32 (``product_3xtf32``;
    products of two TF32 parts are exact in fp32), the scores scaled and the
    mask's bias added in fp32, the unnormalised p = exp(s − max) split as the
    kernels split it in registers, and out = (P·V) / Σp. The adds here round
    to nearest; the card's accumulator is coarser (``csrc/flash_attn.cu``),
    so this shows what the split products cost, not the accumulator."""
    scores = _scores(q, k, kv_mask, sm_scale, product_3xtf32)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    return product_3xtf32(p, v) / p.sum(dim=-1, keepdim=True)


def attention_bwd_3xtf32_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             kv_mask: torch.Tensor | None, sm_scale: float,
                             out: torch.Tensor, lse: torch.Tensor, d_out: torch.Tensor):
    """The fp32 backward's five products (Q·Kᵀ, dO·Vᵀ, Pᵀ·dO, dS·K, dSᵀ·Q) in
    3xTF32, emulated, as ``attention_3xtf32_ref`` emulates the forward's."""
    return _bwd(q, k, v, kv_mask, sm_scale, out, lse, d_out, product_3xtf32)


def _bhsd(*tensors):
    return [t.transpose(1, 2) for t in tensors]


def _shapes(q, k, v, kv_mask):
    """(B, Sq, H, D, Sk) of (B, Sq, H, D) q and (B, Sk, H, D) k, v; raises on
    shapes that do not pair."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or \
            (k.shape[0], k.shape[2], k.shape[3]) != (q.shape[0], q.shape[2], q.shape[3]):
        raise ValueError(f"flash_attn: q (B, Sq, H, D) and k, v (B, Sk, H, D) expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    if kv_mask is not None and tuple(kv_mask.shape) != (b, s_k):
        raise ValueError(f"flash_attn: kv_mask must be (B, Sk) = {(b, s_k)}, "
                         f"got {tuple(kv_mask.shape)}")
    return b, s_q, h, d, s_k


def _operands(q, k, v, kv_mask, plan):
    """The kernels' operands, checked: contiguous q, k, v of one type (16-byte
    aligned for the tuned forward's loads: a copy where not) and an fp32
    mask."""
    b, s_q, h, d, s_k = _shapes(q, k, v, kv_mask)
    dt = q.dtype
    require("flash_attn", q, "q", (b, s_q, h, d), dtype=dt)
    require("flash_attn", k, "k", (b, s_k, h, d), dtype=dt)
    require("flash_attn", v, "v", (b, s_k, h, d), dtype=dt)
    if kv_mask is not None:
        require("flash_attn", kv_mask, "kv_mask", (b, s_k))
    if plan.design.startswith("tuned"):
        q, k, v = aligned(q), aligned(k), aligned(v)
    return q, k, v


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _forward(q, k, v, kv_mask, sm_scale: float, with_lse: bool):
    """(out (B, Sq, H, D) fp32, lse (B, H, Sq) fp32 or None)."""
    b, s_q, h, d, s_k = _shapes(q, k, v, kv_mask)
    if runs_plain("flash_attn", *[t for t in (q, k, v, kv_mask) if t is not None]):
        bq, bk, bv = _bhsd(q, k, v)
        out = attention_ref(bq, bk, bv, kv_mask, sm_scale).transpose(1, 2)
        return out, attention_lse_ref(bq, bk, kv_mask, sm_scale) if with_lse else None
    plan = plan_attention(d, q.dtype, s_q, s_k)
    q, k, v = _operands(q, k, v, kv_mask, plan)
    out = torch.empty((b, s_q, h, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device) if with_lse else None
    shift = attention_shift(kv_mask, b, q.device) if with_lse and kv_mask is not None else None
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_mask), _ptr(shift),
            out.data_ptr(), _ptr(lse), b, h, s_q, s_k)
    if plan.symbol == "flash_any_fwd":
        status = kernel(plan.symbol)(int(q.dtype == torch.bfloat16), *args, d, float(sm_scale),
                                     stream_of(q))
    else:
        status = kernel(plan.symbol)(*args, float(sm_scale), stream_of(q))
    check("flash_attn", status)
    count_launch(flash_attn, q.dtype, (d,))
    return out, lse


def _launch_dq(bf16: int, common: tuple, out, d_out, lse, delta, dq, sizes: tuple) -> None:
    """``csrc/flash_bwd.cu``'s dQ kernel; it writes Dᵢ = Σ dO∘O to ``delta``,
    which the dK/dV kernel reads, so it is launched first."""
    check("flash_attn dq", kernel("flash_bwd_dq")(
        bf16, *common, out.data_ptr(), d_out.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), *sizes))


def _launch_dkv(bf16: int, common: tuple, d_out, lse, delta, dk, dv, sizes: tuple) -> int:
    """``csrc/flash_bwd.cu``'s dK/dV kernel, which picks its own launches
    (two, dV then dK, past a padded D of 128); returns how many it made."""
    launched = ctypes.c_int(0)
    check("flash_attn dkv", kernel("flash_bwd_dkv")(
        bf16, *common, d_out.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), *sizes, ctypes.addressof(launched)))
    return launched.value


def _backward(q, k, v, kv_mask, sm_scale: float, out, lse, d_out):
    """(dq, dk, dv) in q's layout and type."""
    b, s_q, h, d, s_k = _shapes(q, k, v, kv_mask)
    if runs_plain("flash_attn", *[t for t in (q, k, v, kv_mask) if t is not None]):
        grads = attention_bwd_ref(*_bhsd(q, k, v), kv_mask, sm_scale,
                                  *_bhsd(out), lse, *_bhsd(d_out))
        return [g.transpose(1, 2) for g in grads]
    plan = plan_attention(d, q.dtype, s_q, s_k)
    q, k, v = _operands(q, k, v, kv_mask, plan)
    bf16 = int(q.dtype == torch.bfloat16)
    d_out = d_out.to(q.dtype).contiguous()
    require("flash_attn", out, "out", (b, s_q, h, d))
    require("flash_attn", lse, "lse", (b, h, s_q))
    shift = None if kv_mask is None else attention_shift(kv_mask, b, q.device)
    delta = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_mask), _ptr(shift))
    sizes = (b, h, s_q, s_k, d, float(sm_scale), stream_of(q))
    _launch_dq(bf16, common, out, d_out, lse, delta, dq, sizes)
    count_launch(flash_attn, ("dq", q.dtype), (d,))
    for _ in range(_launch_dkv(bf16, common, d_out, lse, delta, dk, dv, sizes)):
        count_launch(flash_attn, ("dkv", q.dtype), (d,))
    return dq, dk, dv


class _FlashAttn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_mask, sm_scale):
        out, lse = _forward(q, k, v, kv_mask, sm_scale, with_lse=True)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, kv_mask, ctx.sm_scale, out, lse, d_out)
        return dq, dk, dv, None, None


def flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               kv_mask: torch.Tensor | None, sm_scale: float) -> torch.Tensor:
    """(B, Sq, H, D) q and (B, Sk, H, D) k, v, fp32 or bf16 (the projections'
    layout), and an optional (B, Sk) fp32 mask, 1 attend / 0 pad →
    (B, Sq, H, D) fp32, differentiable in q, k and v.

    ``.launches`` counts each kernel launch by key: the forward's by operand
    type, the backward's by ("dq", type) and ("dkv", type); ``.widths`` by
    (that key, (D,))."""
    if needs_grad(q, k, v):
        return _FlashAttn.apply(q, k, v, kv_mask, sm_scale)
    return _forward(q, k, v, kv_mask, sm_scale, with_lse=False)[0]


flash_attn.launches, flash_attn.widths = collections.Counter(), collections.Counter()


def scaled_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_mask: torch.Tensor | None = None,
                     sm_scale: float) -> torch.Tensor:
    """The JAX function's interface: (B, H, Sq, D) q, (B, H, Sk, D) k, v and
    an optional (B, Sk) mask → (B, H, Sq, D) fp32 (a view of a (B, Sq, H, D)
    tensor)."""
    def bshd(t):
        return t.transpose(1, 2).contiguous()

    return flash_attn(bshd(q), bshd(k), bshd(v), kv_mask, sm_scale).transpose(1, 2)
