"""Multi-head attention (port of msla_tpu/nn/attention.py), key-padding path.

Separate q/k/v/out projections (``F.linear``) around ``ops.flash_attn``: the
projections' (B, S, E) output is viewed as (B, S, H, D) and handed to the
kernel as it is, and its (B, S, H, D) output is viewed back as (B, S, E), so
no transpose is copied. With ``dtype`` bf16 the projections run as flax's
``Dense(dtype=bfloat16)`` and hand the kernel bf16 q, k and v; its fp32
output goes through ``out_proj`` back to bf16. The additive ``mask`` path
and attention dropout are the transformer's (ROADMAP.md queue item 4) and
raise until then.
"""
from __future__ import annotations

import torch
from torch import nn

from msla_tpu_torch.nn.layers import dense, linear
from msla_tpu_torch.ops.flash_attn import flash_attn


def attend(q_proj: nn.Linear, k_proj: nn.Linear, v_proj: nn.Linear, out_proj: nn.Linear,
           num_heads: int, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
           kv_mask: torch.Tensor | None = None,
           dtype: torch.dtype | None = None) -> torch.Tensor:
    """(B, Sq, E) queries, (B, Sk, E) keys and values, optional (B, Sk) mask →
    (B, Sq, E), in ``dtype`` (fp32 for None). Shared by ``MultiHeadAttention``
    and BERT's attention, whose projections keep HF's names."""
    b, s_q, e = query.shape
    s_k = key.shape[1]
    head_dim = e // num_heads
    q = dense(q_proj, query, dtype).view(b, s_q, num_heads, head_dim)
    k = dense(k_proj, key, dtype).view(b, s_k, num_heads, head_dim)
    v = dense(v_proj, value, dtype).view(b, s_k, num_heads, head_dim)
    out = flash_attn(q, k, v, kv_mask, 1.0 / float(head_dim) ** 0.5)
    return dense(out_proj, out.reshape(b, s_q, e), dtype)


class MultiHeadAttention(nn.Module):
    """Batch-first (B, S, E) attention with the JAX module's parameter names
    (``q_proj``, ``k_proj``, ``v_proj``, ``out_proj``) and init."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0, *,
                 generator: torch.Generator, device):
        super().__init__()
        if dropout:
            raise NotImplementedError(
                f"dropout={dropout}: attention dropout belongs to the transformer, "
                "ROADMAP.md queue item 4")
        self.num_heads = num_heads
        kw = dict(generator=generator, device=device)
        self.q_proj = linear(embed_dim, embed_dim, **kw)
        self.k_proj = linear(embed_dim, embed_dim, **kw)
        self.v_proj = linear(embed_dim, embed_dim, **kw)
        self.out_proj = linear(embed_dim, embed_dim, **kw)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                mask: torch.Tensor | None = None,
                kv_mask: torch.Tensor | None = None) -> torch.Tensor:
        if mask is not None:
            raise NotImplementedError("an additive attention mask is the transformer's "
                                      "path, ROADMAP.md queue item 4")
        return attend(self.q_proj, self.k_proj, self.v_proj, self.out_proj, self.num_heads,
                      query, key, value, kv_mask)
