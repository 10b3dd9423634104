"""VectorQuantizer module (port of msla_tpu/nn/vector_quantizer.py).

Holds the (num_embedding, embedding_dim) codebook, initialised
U(±1/num_embedding), as ``codebook.weight`` (the reference's nn.Embedding
key), and delegates the math to msla_tpu_torch.ops.vq. Inputs are (..., D).
"""
from __future__ import annotations

import torch
from torch import nn

from msla_tpu_torch.nn.layers import uniform_
from msla_tpu_torch.ops.vq import VQResult, vector_quantize


class VectorQuantizer(nn.Module):
    def __init__(self, num_embedding: int, embedding_dim: int, commitment_cost: float,
                 use_pallas: bool | None = None, *, generator: torch.Generator, device):
        super().__init__()
        self.commitment_cost = commitment_cost
        self.use_pallas = use_pallas
        self.codebook = nn.utils.skip_init(nn.Embedding, num_embedding, embedding_dim,
                                           device=device)
        uniform_(self.codebook.weight, 1.0 / num_embedding, generator)

    def forward(self, x: torch.Tensor, inference: bool = False) -> VQResult:
        # inference=True pins the lookup path, as the JAX module does: it
        # computes only what inference reads, where the fused training kernel
        # always computes every output
        return vector_quantize(x, self.codebook.weight, self.commitment_cost,
                               use_pallas=False if inference else self.use_pallas)

    def lookup(self, indices: torch.Tensor) -> torch.Tensor:
        """Code ids → codebook rows, (...,) → (..., D)."""
        return self.codebook.weight.index_select(0, indices.reshape(-1)).reshape(
            *indices.shape, -1)
