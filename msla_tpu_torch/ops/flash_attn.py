"""Attention with a key-padding mask (port of msla_tpu/ops/flash_attn.py).

softmax(q·kᵀ·sm_scale + (1 − kv_mask)·(−1e9))·v in fp32. On CUDA tensors
``flash_attn`` launches the hand-written kernel ``csrc/flash_attn.cu``, which
keeps the (S, S) scores out of device memory with an online softmax; on CPU
tensors it runs ``attention_ref``, the JAX package's XLA chain
(``_xla_attention``): scaled scores plus the mask bias, an fp32 softmax, then
``@ v``.

Both follow that chain on every row, padded query rows included, and a
sequence whose keys are all padding gets the mean of v (its scores all round
to −1e9). The JAX TPU kernel differs at padded query rows (it masks with
segment ids); the port does not.

With bf16 q, k and v (the bf16 compute_dtype) the function is
``_xla_attention``'s on bf16 operands: fp32 scores of the exact products, an
fp32 softmax, the probabilities rounded to bf16 before ``@ v``, which sums in
fp32, and an fp32 output. The kernel rounds the unnormalised p = exp(s − m)
instead, as JAX's TPU kernel does, so the two part by up to 2⁻⁸ of Σₖ pₖ|vₖ|.
``attention_3xtf32_ref`` emulates the fp32 kernel's 3xTF32 products for the
tests; no wrapper calls it.
"""
from __future__ import annotations

import collections

import torch

from msla_tpu_torch.ops._build import (check, count_launch, kernel, require, runs_plain,
                                       stream_of)
from msla_tpu_torch.ops.tf32 import product_3xtf32

#: the head width the CUDA kernel is compiled for (bert-base: 768 / 12)
D = 64


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_mask: torch.Tensor | None, sm_scale: float) -> torch.Tensor:
    """Plain version on (B, H, S, D) tensors, fp32 or bf16; fp32 out."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if kv_mask is not None:
        scores = scores + (1.0 - kv_mask[:, None, None, :].to(torch.float32)) * -1e9
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", weights.float(), v.float())


def attention_3xtf32_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_mask: torch.Tensor | None, sm_scale: float) -> torch.Tensor:
    """The fp32 kernel's arithmetic on (B, H, S, D) fp32 tensors, emulated:
    Q·Kᵀ and P·V in 3xTF32 (``product_3xtf32``; products of two TF32 parts
    are exact in fp32), the scores scaled and the mask's bias added in fp32,
    the unnormalised p = exp(s − max) split as the kernel splits it in
    registers, and out = (P·V) / Σp. The adds here round to nearest; the
    card's accumulator is coarser (``csrc/flash_attn.cu``), so this shows
    what the split products cost, not the accumulator."""
    scores = product_3xtf32(q, k.transpose(-1, -2)) * sm_scale
    if kv_mask is not None:
        scores = scores + (1.0 - kv_mask[:, None, None, :].to(torch.float32)) * -1e9
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    return product_3xtf32(p, v) / p.sum(dim=-1, keepdim=True)


def flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               kv_mask: torch.Tensor | None, sm_scale: float) -> torch.Tensor:
    """(B, S, H, D) q, k, v, fp32 or bf16 (the projections' layout), and an
    optional (B, S) fp32 mask, 1 attend / 0 pad → (B, S, H, D) fp32."""
    tensors = (q, k, v) if kv_mask is None else (q, k, v, kv_mask)
    if runs_plain("flash_attn", *tensors):
        out = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                            kv_mask, sm_scale)
        return out.transpose(1, 2)

    b, s, h, _ = q.shape
    bf16 = q.dtype == torch.bfloat16
    for name, t in (("q", q), ("k", k), ("v", v)):
        require("flash_attn", t, name, (b, s, h, D),
                dtype=torch.bfloat16 if bf16 else torch.float32)
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attn: {name} must be 16-byte aligned (16-byte loads)")
    if kv_mask is not None:
        require("flash_attn", kv_mask, "kv_mask", (b, s))
    out = torch.empty((b, s, h, D), dtype=torch.float32, device=q.device)
    check("flash_attn", kernel("flash_attn_bf16_fwd" if bf16 else "flash_attn_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if kv_mask is None else kv_mask.data_ptr(), out.data_ptr(),
        b, h, s, float(sm_scale), stream_of(q)))
    count_launch(flash_attn, q.dtype)
    return out


flash_attn.launches = collections.Counter()


def scaled_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_mask: torch.Tensor | None = None,
                     sm_scale: float) -> torch.Tensor:
    """The JAX function's interface: (B, H, S, D) q, k, v and an optional
    (B, S) mask → (B, H, S, D) fp32 (a view of a (B, S, H, D) tensor)."""
    def bshd(t):
        return t.transpose(1, 2).contiguous()

    return flash_attn(bshd(q), bshd(k), bshd(v), kv_mask, sm_scale).transpose(1, 2)
