"""Vector quantization (port of msla_tpu/ops/vq.py).

Sonnet-style VQ: L2 nearest-codebook lookup, codebook gather, straight-through
output, the codebook ("embedding") and commitment losses under the reference's
swapped names, and code-usage perplexity. Two paths, as in the JAX package:

* the fused training path (``use_pallas`` None or True): one ``vq_fused_fwd``
  kernel gives ids, quantized rows, counts and Σ‖q − x‖²; its custom backward
  gives dx in closed form and dcb through the ``vq_codebook_grad`` kernel;
* the lookup path (``use_pallas=False``, and inference): the ``nearest_codes``
  kernel, then ``index_select`` and the losses by autograd.

The perplexity is that of the global batch's code usage, as the JAX package's
jitted step computes it on the global array: in a data-parallel step
(``parallel.mesh.data_axis``) the counts and the row count are summed over
the ranks first, one (K + 1)-long all-reduce on the stream. Perplexity is not
linear in the batch, so the mean of the ranks' own would not be JAX's value.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from msla_tpu_torch.ops.nearest_codes import nearest_codes
from msla_tpu_torch.ops.vq_fused import vq_codebook_grad, vq_fused_fwd
from msla_tpu_torch.parallel.mesh import all_sum, sharded


class VQResult(NamedTuple):
    quantized_ste: torch.Tensor     # x + (q - x).detach(), same shape as x
    quantized: torch.Tensor         # raw codebook rows
    embedding_loss: torch.Tensor    # mse(q, x.detach()) — reference's (swapped) name
    commitment_loss: torch.Tensor   # beta * mse(q.detach(), x)
    perplexity: torch.Tensor        # exp(entropy of code usage)
    encoding_indices: torch.Tensor  # (...,) int32 code ids


def _perplexity(counts: torch.Tensor, n: int) -> torch.Tensor:
    """From a rank's (K,) code counts of its ``n`` rows, the global batch's."""
    if sharded():
        total = all_sum(torch.cat([counts, counts.new_full((1,), n)]))
        counts, n = total[:-1], total[-1]
    avg_probs = counts / n
    return torch.exp(-torch.sum(avg_probs * torch.log(avg_probs + 1e-10)))


def code_usage_perplexity(indices: torch.Tensor, num_embedding: int) -> torch.Tensor:
    """exp(-Σ p log(p + 1e-10)) over the empirical code distribution."""
    counts = torch.bincount(indices.reshape(-1), minlength=num_embedding).float()
    return _perplexity(counts, indices.numel())


def _vector_quantize_lookup(x: torch.Tensor, codebook: torch.Tensor,
                            commitment_cost: float) -> VQResult:
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


class _FusedVQ(torch.autograd.Function):
    """JAX's ``_vector_quantize_fused_raw`` custom VJP (msla_tpu/ops/vq.py:83-127).

    Outputs (quantized_ste, quantized, embedding_loss, commitment_loss, idx,
    counts) of flat (N, D) rows. The STE output and the raw rows are equal in
    value but are two tensors, so their cotangents stay apart: the STE's goes
    to x, the raw rows' to the codebook. Likewise the two losses, both
    ‖q − x‖²/(N·D) here; β scales the commitment loss outside the Function.
    """

    @staticmethod
    def forward(ctx, flat, codebook):
        q, idx, counts, sq = vq_fused_fwd(flat, codebook)
        mse = sq / flat.numel()
        ctx.save_for_backward(flat, q, idx)
        ctx.num_codes = codebook.shape[0]
        ctx.mark_non_differentiable(idx, counts)
        ctx.set_materialize_grads(False)
        return q.clone(), q, mse.clone(), mse, idx, counts

    @staticmethod
    def backward(ctx, g_ste, g_q, g_emb, g_commit, _g_idx, _g_counts):
        # an output that nothing used has no gradient (None), not a zero tensor
        flat, q, idx = ctx.saved_tensors
        coef = 2.0 / flat.numel()
        dx = dcb = None
        if ctx.needs_input_grad[0]:
            # the STE identity + the commitment term; the embedding loss has sg(x)
            dx = _plus(g_ste, g_commit, lambda: (coef * g_commit) * (flat - q))
        if ctx.needs_input_grad[1]:
            # the gather's transpose of the raw rows' gradient + the embedding term
            g_eff = _plus(g_q, g_emb, lambda: (coef * g_emb) * (q - flat))
            if g_eff is not None:
                dcb = vq_codebook_grad(g_eff.contiguous(), idx, ctx.num_codes)
        return dx, dcb


def _plus(g, g_loss, term):
    """g + term() where either may be absent (None)."""
    if g_loss is None:
        return g
    return term() if g is None else g + term()


def _vector_quantize_fused(x: torch.Tensor, codebook: torch.Tensor,
                           commitment_cost: float) -> VQResult:
    input_shape = x.shape
    flat = x.reshape(-1, input_shape[-1]).contiguous()
    q_ste, q, emb, commit, idx, counts = _FusedVQ.apply(flat, codebook)
    return VQResult(q_ste.reshape(input_shape), q.reshape(input_shape), emb,
                    commitment_cost * commit, _perplexity(counts, flat.shape[0]),
                    idx.reshape(input_shape[:-1]))


def vector_quantize(x: torch.Tensor, codebook: torch.Tensor, commitment_cost: float,
                    use_pallas: bool | None = None) -> VQResult:
    """Quantize (..., D) activations against a (K, D) codebook.

    ``use_pallas`` keeps the JAX package's name and meaning: None or True
    takes the fused training path, False the lookup path.
    """
    if use_pallas is False:
        return _vector_quantize_lookup(x, codebook, commitment_cost)
    return _vector_quantize_fused(x, codebook, commitment_cost)
