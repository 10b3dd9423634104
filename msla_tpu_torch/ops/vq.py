"""Vector-quantization forward (port of the inference half of msla_tpu/ops/vq.py).

Sonnet-style VQ: L2 nearest-codebook lookup (the ``nearest_codes`` kernel),
codebook gather, straight-through output, the codebook ("embedding") and
commitment losses under the reference's swapped names, and code-usage
perplexity. The fused training VQ (msla_tpu/ops/vq_fused.py) is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from msla_tpu_torch.ops.nearest_codes import nearest_codes


class VQResult(NamedTuple):
    quantized_ste: torch.Tensor     # x + (q - x).detach(), same shape as x
    quantized: torch.Tensor         # raw codebook rows
    embedding_loss: torch.Tensor    # mse(q, x.detach()) — reference's (swapped) name
    commitment_loss: torch.Tensor   # beta * mse(q.detach(), x)
    perplexity: torch.Tensor        # exp(entropy of code usage)
    encoding_indices: torch.Tensor  # (...,) int32 code ids


def code_usage_perplexity(indices: torch.Tensor, num_embedding: int) -> torch.Tensor:
    """exp(-Σ p log(p + 1e-10)) over the empirical code distribution."""
    counts = torch.bincount(indices.reshape(-1), minlength=num_embedding).float()
    avg_probs = counts / indices.numel()
    return torch.exp(-torch.sum(avg_probs * torch.log(avg_probs + 1e-10)))


def vector_quantize(x: torch.Tensor, codebook: torch.Tensor,
                    commitment_cost: float) -> VQResult:
    """Quantize (..., D) activations against a (K, D) codebook."""
    input_shape = x.shape
    flat = x.reshape(-1, input_shape[-1])
    # the ids carry no gradient, so the lookup never needs one
    indices = nearest_codes(flat.detach(), codebook.detach())
    quantized = codebook.index_select(0, indices).reshape(input_shape)

    commitment_loss = commitment_cost * torch.mean((quantized.detach() - x) ** 2)
    embedding_loss = torch.mean((quantized - x.detach()) ** 2)

    quantized_ste = x + (quantized - x).detach()
    perplexity = code_usage_perplexity(indices, codebook.shape[0])
    return VQResult(quantized_ste, quantized, embedding_loss, commitment_loss,
                    perplexity, indices.reshape(input_shape[:-1]))
