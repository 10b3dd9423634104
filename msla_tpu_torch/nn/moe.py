"""Mixture-of-experts FFN (port of msla_tpu/nn/moe.py), the FFN of
configs/experiment/moe_transformer.yaml.

Per-token top-k routing into E ReLU FFN experts, in the JAX module's
dispatch-and-combine form: routing in fp32 (softmax, then k rounds of argmax,
mask and renormalised gates); each group (a batch row) gives each expert
C = ⌈k·S·capacity_factor/E⌉ slots, filled in k order (all first choices,
then all second choices), in token order within a round; a token past its
expert's capacity is dropped from that expert (it rides the residual). One-hot
``dispatch`` and gate-weighted ``combine`` (G, S, E, C) tensors move the
tokens into (E, G, C, M) expert buffers and back. The JAX package computes
all of it with XLA einsums outside any kernel, so here it is plain torch
products (``einsum``), with TF32 off in fp32.

The Switch load-balance loss E·Σₑ fₑ·Pₑ (fₑ the share of tokens whose first
choice is e, Pₑ the mean router probability of e) is the JAX module's
``sow("losses", "moe_aux", ...)``; here ``forward`` returns it beside the
output. In a data-parallel step (``parallel.mesh.data_axis``) both means are
the global batch's, as in the JAX step on the global array; capacity is a
group's (a row's), so dispatch needs no collective. Parameters keep the JAX
layout: ``router`` (M, E), ``w1`` (E, M, F), ``b1`` (E, F), ``w2`` (E, F, M),
``b2`` (E, M).

Expert parallelism (msla_tpu/parallel/mesh.py:96-98, msla_tpu/nn/moe.py:
68-102): with a ``model_axis`` (``parallel/sharding.py`` sets it) this rank
holds E/mp experts' ``w1``, ``b1``, ``w2`` and ``b2``, the block of its model
index. The router is whole on every model peer, and every peer routes the
same tokens, so capacity and the drop order come from the full token set
alike on each; each computes its experts' part of the combine, and the model
group sums the parts in one all-reduce (``ModelAxis.reduce``). No
all_to_all is needed, where the JAX module's comments expect XLA to lower
the dispatch and combine to one (msla_tpu/nn/moe.py:10, 95): model peers
hold the same tokens, so no token has to move to its expert's rank.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from msla_tpu_torch.nn.layers import dropout as drop, uniform_
from msla_tpu_torch.parallel.mesh import all_sum_autograd, sharded


def route(probs: torch.Tensor, k: int, c: int) -> tuple[torch.Tensor, torch.Tensor,
                                                       torch.Tensor]:
    """(G, S, E) router probabilities → top-``k`` (dispatch, combine) at
    ``c`` slots an expert, (G, S, E, C) each, and the first choices'
    one-hots, (G, S, E)."""
    e = probs.shape[-1]
    gates, p = [], probs
    for _ in range(k):  # iterative top-k: argmax, mask, renormalise
        oh = F.one_hot(torch.argmax(p, dim=-1), e).to(probs.dtype)
        gates.append(((p * oh).sum(-1), oh))
        p = p * (1.0 - oh)
    denom = sum(gate for gate, _ in gates) + 1e-9
    gates = [(gate / denom, oh) for gate, oh in gates]

    slots = torch.arange(c, device=probs.device)
    counts = torch.zeros((probs.shape[0], 1, e), dtype=probs.dtype, device=probs.device)
    dispatch = combine = 0.0
    for gate, oh in gates:  # the first choices take their slots first
        pos = counts + torch.cumsum(oh, dim=1) - oh
        counts = counts + oh.sum(dim=1, keepdim=True)
        pos_tok = (pos * oh).sum(-1).to(torch.int32)
        oh = oh * (pos_tok < c)[..., None]
        # jax.nn.one_hot of a position past C is all zeros
        slot = oh[..., None] * (pos_tok[..., None] == slots).to(probs.dtype)[:, :, None, :]
        dispatch = dispatch + slot
        combine = combine + gate[..., None, None] * slot
    return dispatch, combine, gates[0][1]


class MoEFFN(nn.Module):
    model_axis = None   # a ModelAxis: this rank's experts only
    model_sharded = ("w1", "b1", "w2", "b2")

    def __init__(self, d_model: int, d_ff: int, num_experts: int, num_selected: int = 2,
                 capacity_factor: float = 1.25, dropout: float = 0.0,
                 dtype: torch.dtype | None = None, *, generator: torch.Generator, device):
        """Init as the JAX module's: the router U(±1/√M) (``torch_kernel_init``),
        each expert's kernels U(±1/√fan_in) of that expert alone
        (``_expert_kernel_init``), ``b1`` U(±1/√M) and ``b2`` U(±1/√F)."""
        super().__init__()
        self.num_experts, self.num_selected = num_experts, num_selected
        self.capacity_factor, self.dropout, self.dtype = capacity_factor, dropout, dtype
        e, m, f = num_experts, d_model, d_ff
        shapes = {"router": ((m, e), m), "w1": ((e, m, f), m), "b1": ((e, f), m),
                  "w2": ((e, f, m), f), "b2": ((e, m), f)}
        for name, (shape, fan_in) in shapes.items():
            p = nn.Parameter(torch.empty(shape, device=device))
            uniform_(p, 1.0 / fan_in ** 0.5, generator)
            setattr(self, name, p)

    def capacity(self, seq_len: int) -> int:
        k = min(self.num_selected, self.num_experts)
        return max(1, int(-(-k * seq_len * self.capacity_factor // self.num_experts)))

    def routing(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
        """(G, S, M) → (dispatch, combine, probs, first choices' one-hots):
        (G, S, E, C), (G, S, E, C), (G, S, E), (G, S, E), all fp32."""
        probs = torch.softmax(torch.einsum("gsm,me->gse", x.float(), self.router), dim=-1)
        dispatch, combine, first = route(probs, min(self.num_selected, self.num_experts),
                                         self.capacity(x.shape[1]))
        return dispatch, combine, probs, first

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """(G, S, M) → ((G, S, M) fp32, the aux loss, a scalar)."""
        dispatch, combine, probs, first = self.routing(x)
        cdt = x.dtype if self.dtype is None else self.dtype
        ax, xe, shard = self.model_axis, x, {}
        if ax is not None:   # this rank's experts: their slots of dispatch and combine
            local = self.w1.shape[0]
            dispatch = dispatch.narrow(2, ax.index * local, local)
            combine = ax.enter(combine).narrow(2, ax.index * local, local)
            xe, shard = ax.enter(x), dict(shard=(0, ax.index, ax.size))
        xin = torch.einsum("gsec,gsm->egcm", dispatch.to(cdt), xe.to(cdt))
        h = torch.relu(torch.einsum("egcm,emf->egcf", xin, self.w1.to(cdt))
                       + self.b1[:, None, None, :].to(cdt))
        h = drop(h, self.dropout, generator, deterministic, **shard)
        out = torch.einsum("egcf,efm->egcm", h, self.w2.to(cdt)) \
            + self.b2[:, None, None, :].to(cdt)
        y = torch.einsum("gsec,egcm->gsm", combine.to(cdt), out)
        if ax is not None:
            y = ax.reduce(y.float())
        e = self.num_experts
        if sharded():
            # fₑ and Pₑ are means over the global batch: their numerators and
            # the token count are summed over the ranks (with autograd)
            # before the product, which is not linear in them
            sums = all_sum_autograd(torch.cat([
                first.sum(dim=(0, 1)), probs.sum(dim=(0, 1)),
                probs.new_full((1,), first.shape[0] * first.shape[1])]))
            frac, mean_prob = sums[:e] / sums[-1], sums[e:2 * e] / sums[-1]
        else:
            frac, mean_prob = first.mean(dim=(0, 1)), probs.mean(dim=(0, 1))
        return y.float(), e * (frac * mean_prob).sum()
