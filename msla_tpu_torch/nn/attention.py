"""Multi-head attention (port of msla_tpu/nn/attention.py).

Separate q/k/v/out projections (``F.linear``) around one of two paths, as in
the JAX module:

* key-padding (or no) mask and no dropout (Audio-BERT): ``ops.flash_attn``.
  The projections' (B, S, E) output is viewed as (B, S, H, D) and handed to
  the kernel as it is, and its (B, S, H, D) output is viewed back as
  (B, S, E), so no transpose is copied.
* an additive ``mask`` (the transformer's causal mask) or live attention
  dropout: the XLA chain of the JAX module (msla_tpu/nn/attention.py:57-74)
  in plain torch products, which the JAX package runs outside any kernel:
  fp32 scores · scale, plus ``mask``, plus (1 − kv_mask)·(−1e9), an fp32
  softmax, dropout on the weights, the weights cast to v's dtype for P·V,
  which sums in fp32.

With ``dtype`` bf16 the projections run as flax's ``Dense(dtype=bfloat16)``;
the fp32 attention output goes through ``out_proj`` back to bf16.
"""
from __future__ import annotations

import torch
from torch import nn

from msla_tpu_torch.nn.layers import dense, dropout as drop, linear
from msla_tpu_torch.ops.flash_attn import flash_attn


def causal_mask(seq_len: int, dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """Additive causal mask, −inf above the diagonal, (1, 1, S, S) (reference:
    generate_square_subsequent_mask, transformer.py:71)."""
    full = torch.full((seq_len, seq_len), float("-inf"), dtype=dtype, device=device)
    return torch.triu(full, diagonal=1)[None, None]


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor | None, kv_mask: torch.Tensor | None,
                     sm_scale: float, rate: float = 0.0,
                     generator: torch.Generator | None = None,
                     deterministic: bool = True) -> torch.Tensor:
    """The JAX module's XLA chain on (B, H, S, D) q, k, v (fp32 or bf16), an
    additive ``mask`` broadcast to (B, H, Sq, Sk) and a (B, Sk) ``kv_mask``
    (1 attend / 0 pad) → (B, H, Sq, D) fp32."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if mask is not None:
        scores = scores + mask
    if kv_mask is not None:
        scores = scores + (1.0 - kv_mask[:, None, None, :].to(torch.float32)) * -1e9
    weights = drop(torch.softmax(scores, dim=-1), rate, generator, deterministic)
    return torch.matmul(weights.to(v.dtype).float(), v.float())


def attend(q_proj: nn.Linear, k_proj: nn.Linear, v_proj: nn.Linear, out_proj: nn.Linear,
           num_heads: int, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
           kv_mask: torch.Tensor | None = None,
           dtype: torch.dtype | None = None, mask: torch.Tensor | None = None,
           rate: float = 0.0, generator: torch.Generator | None = None,
           deterministic: bool = True) -> torch.Tensor:
    """(B, Sq, E) queries, (B, Sk, E) keys and values, an optional additive
    ``mask`` and (B, Sk) ``kv_mask`` → (B, Sq, E), in ``dtype`` (fp32 for
    None). ``rate`` is the attention dropout, live when not
    ``deterministic``. Shared by ``MultiHeadAttention`` and BERT's
    attention, whose projections keep HF's names."""
    b, s_q, e = query.shape
    s_k = key.shape[1]
    head_dim = e // num_heads
    q = dense(q_proj, query, dtype).view(b, s_q, num_heads, head_dim)
    k = dense(k_proj, key, dtype).view(b, s_k, num_heads, head_dim)
    v = dense(v_proj, value, dtype).view(b, s_k, num_heads, head_dim)
    sm_scale = 1.0 / float(head_dim) ** 0.5
    if mask is None and (deterministic or rate == 0.0):
        out = flash_attn(q, k, v, kv_mask, sm_scale)
    else:
        out = masked_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask,
                               kv_mask, sm_scale, rate, generator,
                               deterministic).transpose(1, 2)
    return dense(out_proj, out.reshape(b, s_q, e), dtype)


class MultiHeadAttention(nn.Module):
    """Batch-first (B, S, E) attention with the JAX module's parameter names
    (``q_proj``, ``k_proj``, ``v_proj``, ``out_proj``) and init, and its
    attention ``dropout``."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 dtype: torch.dtype | None = None, *, generator: torch.Generator, device):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.dtype = dtype
        kw = dict(generator=generator, device=device)
        self.q_proj = linear(embed_dim, embed_dim, **kw)
        self.k_proj = linear(embed_dim, embed_dim, **kw)
        self.v_proj = linear(embed_dim, embed_dim, **kw)
        self.out_proj = linear(embed_dim, embed_dim, **kw)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                mask: torch.Tensor | None = None, kv_mask: torch.Tensor | None = None,
                deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """fp32 out for ``dtype`` None; in bf16 mode the output stays bf16,
        as the JAX module returns it."""
        return attend(self.q_proj, self.k_proj, self.v_proj, self.out_proj, self.num_heads,
                      query, key, value, kv_mask, self.dtype, mask, self.dropout, generator,
                      deterministic)
