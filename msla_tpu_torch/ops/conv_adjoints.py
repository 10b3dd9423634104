"""fp32 cuDNN convolutions, and the adjoints of a k4 s2 p1 conv that the stems'
backward passes use, in fp32 or on bf16 operands (the JAX package takes them
with ``jax.linear_transpose``, msla_tpu/ops/conv_stem.py:177-190 and
deconv_stem.py:180-190)."""
from __future__ import annotations

import torch


def fp32_convs():
    """cuDNN convs in full fp32 (no TF32) for the scope of a call: TF32 keeps
    ~3 decimal digits, enough to flip VQ codes on near-ties. A backward runs
    the convs' adjoints when it runs, so it needs the scope of its own. The
    flag is set on every build of torch, with or without cuDNN."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def conv_grads(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor, *, transposed: bool,
               need_input: bool):
    """(dx or None, dw, db) of y = conv(x, w) + b with kernel 4, stride 2,
    padding 1, at the output gradient g; ``transposed`` for ConvTranspose1d,
    whose output is exactly twice its input, so no output padding is needed.

    In fp32 all three come from cuDNN in full fp32. On bf16 operands dx and dw
    are cuDNN's bf16 adjoints (fp32 accumulation inside, bf16 results), and
    db is g summed in fp32, as the JAX package's ``_fused_bwd`` sums it
    (``jnp.sum(..., dtype=jnp.float32)``), not cuDNN's bf16 bias gradient."""
    bias_size = [w.shape[1] if transposed else w.shape[0]]
    fp32 = g.dtype == torch.float32
    with fp32_convs():
        dx, dw, db = torch.ops.aten.convolution_backward(
            g.contiguous(), x, w, bias_size, [2], [1], [1], transposed, [0], 1,
            [need_input, True, fp32])
    return dx, dw, db if fp32 else g.sum(dim=(0, 2), dtype=torch.float32)
