"""3xTF32 in plain PyTorch: what the fp32 kernels that run on the TF32 tensor
cores (``csrc/tf32_split.cuh``: #6, #7, K1/K1b, K2/K2b, K3, #4) compute,
emulated with fp32 products of TF32 parts, for the tests and
``chip_smoke.py``. No wrapper calls them."""
from __future__ import annotations

import torch


def tf32_round_ref(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds: add half a TF32 ulp to the bit
    pattern's magnitude and clear the 13 low bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def product_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (fp32, batched, broadcast) as the tensor cores take it in 3xTF32:
    each operand split as hi = tf32(x), lo = tf32(x − hi), and per 8-deep step
    of the reduction, in order, lo·hi, hi·lo, then hi·hi added to one fp32
    accumulator. Each product of two TF32 parts is exact in fp32. The adds
    here round to nearest; the card's accumulator is coarser, so this shows
    what the split products cost, not the accumulator."""
    a_hi, b_hi = tf32_round_ref(a), tf32_round_ref(b)
    a_lo, b_lo = tf32_round_ref(a - a_hi), tf32_round_ref(b - b_hi)
    acc = torch.zeros((), dtype=torch.float32, device=a.device)
    for i in range(0, a.shape[-1], 8):
        s = slice(i, i + 8)
        acc = acc + a_lo[..., s] @ b_hi[..., s, :]
        acc = acc + a_hi[..., s] @ b_lo[..., s, :]
        acc = acc + a_hi[..., s] @ b_hi[..., s, :]
    return acc
