"""VQ-VAE network (port of msla_tpu/nn/vqvae_net.py, fuse_stem=True path).

Encoder → 1×1 pre-VQ conv → VectorQuantizer → Decoder. Public tensors keep the
JAX package's layouts: (B, 4, T) stems in and out, ``encode`` returns
(B, W, embedding_dim), quantized latents are (B, embedding_dim, W). Inside,
everything is torch's NCW. The state_dict uses the reference torch model's key
names, so ``utils.jax_compat.vqvae_state_dict_from_jax`` output loads strictly.

``compute_dtype="bfloat16"`` runs the convs in bf16 as the JAX package does,
in inference and under grad: parameters stay fp32 (each layer casts its
weights, and their gradients come back to fp32 through the cast), the pre-VQ
latents are cast to fp32 (so the VQ distances, losses and the straight-through
gradient stay fp32 until that cast) and the decoder's output is fp32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from msla_tpu_torch.device import resolve_device
from msla_tpu_torch.nn.decoder import Decoder
from msla_tpu_torch.nn.encoder import Encoder
from msla_tpu_torch.nn.layers import compute, conv, conv1d
from msla_tpu_torch.nn.vector_quantizer import VectorQuantizer
from msla_tpu_torch.ops.conv_adjoints import fp32_convs


class VQVAEOutput(NamedTuple):
    output: torch.Tensor            # (B, 4, T) reconstructed stems
    embedding_loss: torch.Tensor
    commitment_loss: torch.Tensor
    perplexity: torch.Tensor


class QuantizedOutput(NamedTuple):
    quantized: torch.Tensor         # (B, embedding_dim, W)
    encoding_indices: torch.Tensor  # (B, W) int32
    perplexity: torch.Tensor


class VQVAENet(nn.Module):
    def __init__(self, num_hidden: int, num_residual_layer: int, num_residual_hidden: int,
                 num_embedding: int, embedding_dim: int, commitment_cost: float,
                 use_pallas: bool | None = None, compute_dtype: str | None = None, *,
                 device=None, seed: int = 0):
        """Weights are U(±1/√fan_in) (codebook U(±1/K)) from a torch.Generator
        seeded with ``seed``; ``device`` None means the card. ``use_pallas``
        selects the VQ path of ``forward`` as in the JAX package: None or True
        the fused training VQ, False the lookup."""
        super().__init__()
        self.dtype = compute(compute_dtype)
        dev = resolve_device(device)
        kw = dict(generator=torch.Generator().manual_seed(seed), device=dev)
        self.encoder = Encoder(num_hidden, num_residual_layer, num_residual_hidden,
                               dtype=self.dtype, **kw)
        self.conv = conv1d(num_hidden, embedding_dim, 1, **kw)  # pre-VQ projection
        self.vector_quantizer = VectorQuantizer(num_embedding, embedding_dim,
                                                commitment_cost, use_pallas, **kw)
        self.decoder = Decoder(embedding_dim, num_hidden, num_residual_layer,
                               num_residual_hidden, dtype=self.dtype, **kw)

    def encode(self, x_bcw: torch.Tensor) -> torch.Tensor:
        """(B, 4, T) → (B, W, embedding_dim) pre-quantization latents."""
        with fp32_convs():
            z = conv(self.conv, self.encoder(x_bcw.contiguous()), self.dtype).float()
        return z.transpose(1, 2).contiguous()

    def forward(self, x_bcw: torch.Tensor) -> VQVAEOutput:
        """Forward pass with the VQ loss values."""
        res = self.vector_quantizer(self.encode(x_bcw))
        out = self.decode(res.quantized_ste.transpose(1, 2))
        return VQVAEOutput(out, res.embedding_loss, res.commitment_loss, res.perplexity)

    def get_quantized(self, x_bcw: torch.Tensor) -> QuantizedOutput:
        """Inference path to the quantized representation: the lookup VQ
        whatever ``use_pallas`` says."""
        res = self.vector_quantizer(self.encode(x_bcw), inference=True)
        return QuantizedOutput(res.quantized_ste.transpose(1, 2), res.encoding_indices,
                               res.perplexity)

    def decode(self, quantized_bcw: torch.Tensor) -> torch.Tensor:
        """(B, embedding_dim, W) quantized latents → (B, 4, T) stems."""
        with fp32_convs():
            return self.decoder(quantized_bcw.contiguous())

    def decode_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """(B, W) code ids → (B, 4, T) stems, via codebook lookup + decoder."""
        return self.decode(self.vector_quantizer.lookup(indices).transpose(1, 2))
