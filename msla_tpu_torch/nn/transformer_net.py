"""Transformer decoder over quantized latents (port of
msla_tpu/nn/transformer_net.py; reference: src/model/transformer.py:17-82).

Linear embedding (latent width W → hidden) → positional encoding → N
post-norm decoder layers (causal self-attention, cross-attention, ReLU FFN
or ``MoEFFN``) → a reshape to 4 stems → Linear to the waveform.

The reference feeds an all-zeros memory to every cross-attention. With
V = 0 its output is the out-projection's bias, so ``zero_memory=True`` (the
default) adds that learned bias, ``cross_attn_out_bias``, as the JAX module
does; a ``DecoderLayer`` with ``zero_memory=False`` runs a real
``MultiHeadAttention`` over the memory it is given.

``compute_dtype="bfloat16"`` follows the flax module op by op: each Linear
as flax's ``Dense(dtype=bfloat16)``, the embedding's, the FFN's second
Linear's and ``fc``'s outputs cast back to fp32, and the residual adds
promoted to fp32 (fp32 stream plus bf16 branch), so every LayerNorm runs in
fp32 and the stream between layers stays fp32. Parameters stay fp32.

Dropout (attention, FFN, the three residual branches and the MoE experts')
is live when ``deterministic`` is False and draws from the ``generator``.

Tensor parallelism (msla_tpu/nn/transformer_net.py:66-72, sharded by
``tp_param_spec``): with a ``model_axis`` (``parallel/sharding.py`` sets it)
a layer holds its model peers' block of the FFN, ``linear1``'s output rows
(column parallel, with its block of ``linear1``'s bias) and ``linear2``'s
input columns (row parallel), and sums the peers' partial outputs in one
all-reduce (``ModelAxis.reduce``) before ``linear2``'s bias, added once. The
FFN's dropout mask is drawn whole and cut, as the whole layer draws it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from msla_tpu_torch.device import resolve_device
from msla_tpu_torch.nn.attention import MultiHeadAttention, causal_mask
from msla_tpu_torch.nn.layers import compute, dense, dropout as drop, linear, uniform_
from msla_tpu_torch.nn.moe import MoEFFN
from msla_tpu_torch.nn.positional import PositionalEncoding


class DecoderLayer(nn.Module):
    """torch.nn.TransformerDecoderLayer's function (post-norm, ReLU FFN) under
    the JAX module's parameter names."""

    model_axis = None   # a ModelAxis: the FFN computed on this rank's shards

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, zero_memory: bool = True,
                 dtype: torch.dtype | None = None, moe_experts: int = 0,
                 moe_selected: int = 2, *, generator: torch.Generator, device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.dropout, self.zero_memory, self.dtype = dropout, zero_memory, dtype
        self.self_attn = MultiHeadAttention(d_model, num_heads, dropout, dtype, **kw)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        if zero_memory:
            self.cross_attn_out_bias = nn.Parameter(torch.empty(d_model, device=device))
            uniform_(self.cross_attn_out_bias, 1.0 / d_model ** 0.5, generator)
        else:
            self.cross_attn = MultiHeadAttention(d_model, num_heads, dropout, dtype, **kw)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        if moe_experts > 0:
            self.moe = MoEFFN(d_model, dim_feedforward, moe_experts, num_selected=moe_selected,
                              dropout=dropout, dtype=dtype, **kw)
        else:
            self.linear1 = linear(d_model, dim_feedforward, **kw)
            self.linear2 = linear(dim_feedforward, d_model, **kw)
            self.model_sharded = ("linear1.weight", "linear2.weight")
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor, memory: torch.Tensor | None, mask: torch.Tensor,
                deterministic: bool = True, generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """(B, S, E) fp32 → ((B, S, E) fp32, the MoE aux loss or None)."""
        def dropout(a):
            return drop(a, self.dropout, generator, deterministic)

        sa = self.self_attn(x, x, x, mask=mask, deterministic=deterministic,
                            generator=generator)
        x = self.norm1(x + dropout(sa))
        if self.zero_memory:
            ca = self.cross_attn_out_bias.expand_as(x)
        else:
            ca = self.cross_attn(x, memory, memory, deterministic=deterministic,
                                 generator=generator)
        x = self.norm2(x + dropout(ca))

        aux = None
        if hasattr(self, "moe"):
            h, aux = self.moe(x, deterministic, generator)
        elif self.model_axis is None:
            h = dropout(torch.relu(dense(self.linear1, x, self.dtype)))
            h = dense(self.linear2, h, self.dtype).float()
        else:
            h = self._sharded_ffn(x, deterministic, generator)
        return self.norm3(x + dropout(h)), aux

    def _sharded_ffn(self, x: torch.Tensor, deterministic: bool,
                     generator: torch.Generator | None) -> torch.Tensor:
        """The FFN on this rank's blocks: ``linear1.weight`` (F/mp, M),
        ``linear2.weight`` (M, F/mp), the biases whole."""
        ax, dt = self.model_axis, self.dtype or x.dtype
        part = self.linear1.weight.shape[0]
        b1 = ax.enter(self.linear1.bias).narrow(0, ax.index * part, part)
        h = torch.relu(F.linear(ax.enter(x).to(dt), self.linear1.weight.to(dt)) + b1.to(dt))
        h = drop(h, self.dropout, generator, deterministic, shard=(-1, ax.index, ax.size))
        out = ax.reduce(F.linear(h, self.linear2.weight.to(dt)).float())
        return out + self.linear2.bias.to(dt).float()


class TransformerQuantizerNet(nn.Module):
    """(B, S latent channels, W) quantized latents → (B, 4, T) stems
    (reference: transformer.py:31-82)."""

    def __init__(self, input_dim: int, output_dim: int, hidden_dim: int = 512,
                 num_layers: int = 4, num_heads: int = 8, dropout: float = 0.1,
                 positional_mode: str = "reference", zero_memory: bool = True,
                 compute_dtype: str | None = None, moe_experts: int = 0,
                 moe_selected: int = 2, latent_channels: int = 64, *, device=None,
                 seed: int = 0, generator: torch.Generator | None = None):
        """``latent_channels`` is S, the VQ-VAE's embedding_dim, which sets
        ``fc``'s S·hidden/4 in-features (flax infers it from the first
        batch). Weights from a torch.Generator seeded with ``seed`` (or the
        ``generator`` given), with the JAX package's init families;
        ``device`` None means the card."""
        super().__init__()
        if (latent_channels * hidden_dim) % 4:
            raise ValueError(f"S·hidden = {latent_channels}·{hidden_dim} does not split into "
                             "4 stems")
        dev = resolve_device(device)
        kw = dict(generator=generator or torch.Generator().manual_seed(seed), device=dev)
        self.dtype = compute(compute_dtype)
        self.embedding = linear(input_dim, hidden_dim, **kw)
        self.positional_encoding = PositionalEncoding(hidden_dim, mode=positional_mode,
                                                      device=dev)
        self.num_layers = num_layers
        for i in range(num_layers):  # named layer{i}, as the flax tree
            self.add_module(f"layer{i}", DecoderLayer(
                hidden_dim, num_heads, dropout=dropout, zero_memory=zero_memory,
                dtype=self.dtype, moe_experts=moe_experts, moe_selected=moe_selected, **kw))
        self.fc = linear(latent_channels * hidden_dim // 4, output_dim, **kw)

    def run(self, quantized: torch.Tensor, deterministic: bool = True,
            generator: torch.Generator | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, S, W) → ((B, 4, T) fp32, the MoE aux loss summed over the
        layers, 0 without experts). The layers get no memory, as in the JAX
        module."""
        b, s, _ = quantized.shape
        x = dense(self.embedding, quantized, self.dtype).float()
        x = self.positional_encoding(x)
        mask = causal_mask(s, x.dtype, x.device)
        aux = torch.zeros((), device=x.device)
        for i in range(self.num_layers):
            x, layer_aux = getattr(self, f"layer{i}")(x, None, mask, deterministic, generator)
            if layer_aux is not None:
                aux = aux + layer_aux
        x = x.reshape(b, 4, -1)  # (B, S, hidden) → (B, 4, S·hidden/4)
        return dense(self.fc, x, self.dtype).float(), aux

    def forward(self, quantized: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return self.run(quantized, deterministic, generator)[0]
