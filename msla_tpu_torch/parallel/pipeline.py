"""GPipe over the model groups of the (data, model) rank grid (port of
msla_tpu/parallel/pipeline.py: ``stack_layer_params``, ``spmd_pipeline``,
``pipelined_transformer_apply``, ``pipelined_bert_apply``).

The JAX package stacks the homogeneous layers (the transformer's decoder
layers, BERT's encoder layers) on a leading axis sharded over the mesh's
`model` axis and runs the schedule inside one ``shard_map``: each tick every
stage applies its layers and ``ppermute`` rotates the activations to the next
stage; ``jax.grad`` through it is the reverse schedule. Here a rank is a
stage: rank r's model index (``RankGrid.model_index``) is its stage among its
model peers (``RankGrid.model_peer``), and stage s holds layers
[s·L/pp, (s+1)·L/pp) (``stage_layers``, JAX's order). Every rank keeps every
weight whole, as the JAX Trainer replicates them under the pipeline
(msla_tpu/train/trainer.py:315-328); a stage runs only its own layers.

**The schedule** (``spmd_pipeline``). The rank's batch is cut into
``n_micro`` microbatches of consecutive rows. Stage 0 feeds microbatch k, a
stage runs its layers on it, then sends the activations, and the aux beside
them (BERT's per-example mask), to stage + 1 with ``torch.distributed``'s
point-to-point calls on the model group (NCCL on the card, gloo on the CPU);
stage s runs microbatch k at tick s + k, n_micro + pp − 1 ticks in all, as the
JAX loop unrolls them, except that a stage computes nothing in its bubble
ticks. The last stage's output reaches every model peer (a broadcast over
the model group), as JAX returns the replicated ``y[-1]``: what follows (the
transformer's ``fc``, BERT's MLM transform, the loss, #6) runs on every peer.
At one stage (a model axis of 1) the schedule runs without a send.

**Its own autograd** (``_Pipeline``, a ``torch.autograd.Function``). The
forward keeps each microbatch's graph through its stage's layers; the
backward runs the reverse schedule: microbatches in reverse order, the last
stage taking its rows of the output's gradient (the same on every peer),
each stage sending the gradient of its input to stage − 1. A layer's
parameters are inputs of the Function on the stage that holds them, so
their gradients, summed over the microbatches, accumulate there alone; the
input's gradient comes out on stage 0 (zeros on the other stages).
``mean_gradients`` then sums each layer's gradient over the model group,
counts once a gradient that every peer computes (stage 0's), and takes the
mean over the data group, in one flat all-reduce over the world. Under
``remat`` the Trainer's recomputation replays the whole schedule and the
generator on every rank, at the backward's first step, which every rank
takes alike (it lies after the stages); the stages' own graphs keep their
tensors, so ``remat`` spares the memory of the rest of the loss only.

**Dropout** (``generator``): each (global layer index, microbatch) draws from
a ``torch.Generator`` of its own, seeded from the step generator's state (a
hash of it, so nothing waits for the device) and both indices, as JAX folds
its key (msla_tpu/parallel/pipeline.py:98-106). The draws do not depend on
the stage count; they are not JAX's stream, which no torch generator can
give (ROADMAP.md §3). The step generator moves on by one draw.

The divisibility checks are JAX's, on the global batch (the data size times
the rank's batch): the layers by the stages, the batch by ``n_micro``, the
microbatch by the data axis.
"""
from __future__ import annotations

import hashlib
import struct
from typing import Callable, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from msla_tpu_torch.parallel.mesh import RankGrid, data_info


def stack_layer_params(state_dict: dict, prefixes: Sequence[str]) -> dict[str, torch.Tensor]:
    """Per-layer tensors of one structure stacked on a new leading dim:
    ``stacked[key][i] == state_dict[f"{prefixes[i]}.{key}"]``."""
    keys = [k[len(prefixes[0]) + 1:] for k in state_dict if k.startswith(prefixes[0] + ".")]
    return {key: torch.stack([state_dict[f"{p}.{key}"] for p in prefixes]) for key in keys}


def unstack_layer_params(stacked: dict, prefixes: Sequence[str]) -> dict[str, torch.Tensor]:
    """The inverse of ``stack_layer_params``."""
    return {f"{p}.{key}": t[i] for key, t in stacked.items() for i, p in enumerate(prefixes)}


def stage_layers(n_layers: int, pp: int, stage: int) -> range:
    """The global indices of the layers stage ``stage`` of ``pp`` holds:
    L/pp consecutive layers, in order."""
    per = n_layers // pp
    return range(stage * per, (stage + 1) * per)


def _check_layout(grid: RankGrid | None, n_layers: int, batch: int, n_micro: int) -> None:
    """JAX's ``ValueError``s, for the global batch
    (msla_tpu/parallel/pipeline.py:78-87)."""
    pp = grid.mp if grid is not None else 1
    dp = grid.dp if grid is not None else data_info()[1]
    if n_layers % pp != 0:
        raise ValueError(f"{n_layers} layers not divisible by {pp} stages")
    b = batch * dp
    if b % n_micro != 0:
        raise ValueError(f"batch {b} not divisible by n_micro={n_micro}")
    mb = b // n_micro
    if mb % dp != 0:
        raise ValueError(f"microbatch {mb} not divisible by the data={dp} mesh axis")


def _seed_of(state: torch.Tensor) -> bytes:
    return hashlib.blake2b(state.numpy().tobytes(), digest_size=16).digest()


def _kept():
    """The stage's graphs keep their tensors, under ``remat`` too: the
    checkpoint's hooks would recompute them from inside this backward's own
    ``autograd.grad``, a graph task of its own, on one stage while the others
    wait for it."""
    return torch.autograd.graph.saved_tensors_hooks(lambda t: t, lambda t: t)


class _Schedule:
    """One call's schedule on this rank: its stage's layers, its peers and
    the graphs its backward needs."""

    def __init__(self, layer_apply, layers, grid, n_micro: int, generator):
        self.layer_apply, self.n_micro, self.grid = layer_apply, n_micro, grid
        self.pp, self.stage = (grid.mp, grid.model_index) if grid is not None else (1, 0)
        self.mine = [(i, layers[i]) for i in stage_layers(len(layers), self.pp, self.stage)]
        self.params = [p for _, layer in self.mine for p in layer.parameters() if p.requires_grad]
        self.seed = None
        if generator is not None:   # the step generator's state, then one draw on
            self.seed = _seed_of(generator.get_state())
            self.device = generator.device
            torch.empty(1, device=generator.device).uniform_(generator=generator)
        self.saved: list[tuple[torch.Tensor, torch.Tensor]] = []
        self.pending: list = []

    def generator(self, layer: int, micro: int) -> torch.Generator | None:
        if self.seed is None:
            return None
        digest = hashlib.blake2b(self.seed + struct.pack("<qq", layer, micro),
                                 digest_size=8).digest()
        seed = int.from_bytes(digest, "little") % (1 << 63)
        return torch.Generator(device=self.device).manual_seed(seed)

    def run_stage(self, h: torch.Tensor, a, micro: int) -> torch.Tensor:
        for i, layer in self.mine:
            h = self.layer_apply(layer, h, a, self.generator(i, micro))
        return h

    # point-to-point on the model group, by global rank
    def _send(self, t: torch.Tensor, stage: int) -> None:
        t = t.contiguous()   # kept until the send has landed
        self.pending.append((dist.isend(t, self.grid.model_peer(stage),
                                        group=self.grid.model_group), t))

    def _recv(self, like: torch.Tensor, stage: int) -> torch.Tensor:
        t = torch.empty_like(like, memory_format=torch.contiguous_format)
        dist.recv(t, self.grid.model_peer(stage), group=self.grid.model_group)
        return t

    def _drain(self) -> None:
        for work, _ in self.pending:
            work.wait()
        self.pending = []

    def forward(self, x: torch.Tensor, aux: torch.Tensor | None, keep: bool) -> torch.Tensor:
        """(B, ...) → (B, ...) after every layer, on every peer; with
        ``keep`` each microbatch's graph through this stage is kept."""
        first, last = self.stage == 0, self.stage == self.pp - 1
        xs = x.chunk(self.n_micro) if first else [None] * self.n_micro
        mb = x.shape[0] // self.n_micro
        auxs = aux.chunk(self.n_micro) if aux is not None else [None] * self.n_micro
        outs = []
        for k in range(self.n_micro):
            if first:
                h, a = xs[k].contiguous(), None if aux is None else auxs[k].contiguous()
            else:
                h = self._recv(x[:mb], self.stage - 1)
                a = None if aux is None else self._recv(aux[:mb], self.stage - 1)
            if keep:
                h = h.detach().requires_grad_(True)
                with torch.enable_grad(), _kept():
                    y = self.run_stage(h, a, k)
                self.saved.append((h, y))
                y = y.detach()
            else:
                y = self.run_stage(h, a, k)
            if last:
                outs.append(y)
            else:
                self._send(y, self.stage + 1)
                if a is not None:
                    self._send(a, self.stage + 1)
        self._drain()
        out = torch.cat(outs) if last else torch.empty_like(x, memory_format=torch.contiguous_format)
        if self.pp > 1:
            dist.broadcast(out, self.grid.model_peer(self.pp - 1), group=self.grid.model_group)
        return out

    def backward(self, grad_out: torch.Tensor, want_x: bool):
        """The reverse schedule: (the input's gradient, this stage's
        parameters' gradients summed over the microbatches)."""
        first, last = self.stage == 0, self.stage == self.pp - 1
        mb = grad_out.shape[0] // self.n_micro
        grad_x = torch.zeros_like(grad_out) if want_x else None
        sums: list[torch.Tensor | None] = [None] * len(self.params)
        for k in reversed(range(self.n_micro)):
            h, y = self.saved[k]
            gy = grad_out[k * mb:(k + 1) * mb] if last else self._recv(y, self.stage + 1)
            grads = torch.autograd.grad(y, [h, *self.params], gy, allow_unused=True)
            for j, g in enumerate(grads[1:]):
                if g is not None:
                    sums[j] = g if sums[j] is None else sums[j] + g
            if not first:
                self._send(grads[0], self.stage - 1)
            elif want_x:
                grad_x[k * mb:(k + 1) * mb] = grads[0]
        self._drain()
        self.saved = []
        return grad_x, sums


class _Pipeline(torch.autograd.Function):
    """The schedule as one autograd node: the forward's graphs kept per
    microbatch, the reverse schedule in the backward."""

    @staticmethod
    def forward(ctx, schedule: _Schedule, x, aux, *params):
        ctx.schedule = schedule
        return schedule.forward(x, aux, keep=True)

    @staticmethod
    def backward(ctx, grad_out):
        grad_x, grads = ctx.schedule.backward(grad_out, ctx.needs_input_grad[1])
        return (None, grad_x, None, *grads)


def spmd_pipeline(layer_apply: Callable, layers: Sequence[nn.Module], x: torch.Tensor,
                  grid: RankGrid | None = None, *, n_micro: int,
                  aux: torch.Tensor | None = None,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """Run ``x`` through ``layers`` pipelined over ``grid``'s model groups.

    ``layer_apply(layer, h, a, g) -> h`` applies one layer to a microbatch
    ``h`` with its rows ``a`` of ``aux`` (None without) and its dropout
    generator ``g`` (None without ``generator``); it keeps ``h``'s shape and
    dtype. Without a ``grid`` the schedule has one stage. Returns the (B,
    ...) activations after all layers on every model peer, the sequential
    stack's function."""
    _check_layout(grid, len(layers), x.shape[0], n_micro)
    schedule = _Schedule(layer_apply, layers, grid, n_micro, generator)
    if torch.is_grad_enabled() and (x.requires_grad or schedule.params):
        return _Pipeline.apply(schedule, x, aux, *schedule.params)
    return schedule.forward(x, aux, keep=False)


def mean_gradients(params, layers: Sequence[nn.Module], grid: RankGrid) -> None:
    """The gradients of a pipelined step, after its backward: each layer's
    summed over the model group (its stage alone computed it), each other
    leaf counted once (every peer computed the same; stage 0's is taken),
    then the mean over the data group, in one flat all-reduce over the world.
    A leaf outside the layers with no gradient keeps none, on every rank."""
    owner = {id(p): i * grid.mp // len(layers) for i, layer in enumerate(layers)
             for p in layer.parameters()}
    taken = []
    for p in params:
        if not p.requires_grad or (id(p) not in owner and p.grad is None):
            continue
        mine = owner.get(id(p), 0) == grid.model_index
        taken.append((p, p.grad if mine and p.grad is not None else torch.zeros_like(p)))
    if not taken:
        return
    flat = torch.cat([g.reshape(-1) for _, g in taken])
    dist.all_reduce(flat)
    flat /= grid.dp
    for (p, _), g in zip(taken, torch.split(flat, [p.numel() for p, _ in taken])):
        p.grad = g.view_as(p).clone()


def _decoder_layer(mask: torch.Tensor) -> Callable:
    def apply(layer, h, a, g):
        return layer(h, None, mask, g is None, g)[0]
    return apply


def pipelined_transformer_apply(net, quantized: torch.Tensor, grid: RankGrid | None = None, *,
                                n_micro: int, generator: torch.Generator | None = None
                                ) -> torch.Tensor:
    """``TransformerQuantizerNet.run``'s forward with the decoder layers
    pipelined (msla_tpu/parallel/pipeline.py:139-186): embedding and
    positional encoding before the stages, the reshape to 4 stems and ``fc``
    after them. With ``generator`` the layers' dropout is live, each
    (layer, microbatch) on its own generator; without, deterministic."""
    from msla_tpu_torch.nn.attention import causal_mask
    from msla_tpu_torch.nn.layers import dense

    b, s, _ = quantized.shape
    x = dense(net.embedding, quantized, net.dtype).float()
    x = net.positional_encoding(x)
    layers = [getattr(net, f"layer{i}") for i in range(net.num_layers)]
    x = spmd_pipeline(_decoder_layer(causal_mask(s, x.dtype, x.device)), layers, x, grid,
                      n_micro=n_micro, generator=generator)
    return dense(net.fc, x.reshape(b, 4, -1), net.dtype).float()


def _bert_layer(layer, h, a, g):
    return layer(h, a)


def pipelined_bert_apply(bert, input_ids: torch.Tensor, grid: RankGrid | None = None, *,
                         n_micro: int, attention_mask: torch.Tensor | None = None,
                         return_mlm_hidden: bool = False) -> torch.Tensor:
    """The deterministic ``BertForMaskedLM`` forward with the encoder layers
    pipelined, the per-example attention masks riding beside the
    activations (msla_tpu/parallel/pipeline.py:189-241): the embeddings
    before the stages, the MLM transform and norm [and the tied decoder]
    after them."""
    from msla_tpu_torch.nn.layers import layer_norm

    if attention_mask is None:
        attention_mask = torch.ones(input_ids.shape, device=input_ids.device)
    attention_mask = attention_mask.to(torch.float32).contiguous()
    x = bert.bert.embeddings(input_ids)
    x = spmd_pipeline(_bert_layer, bert.bert.encoder.layer, x, grid, n_micro=n_micro,
                      aux=attention_mask)
    t = bert.cls.predictions.transform
    h = layer_norm(t.LayerNorm, F.gelu(t.dense(x.float())), bert.dtype)
    if return_mlm_hidden:
        return h
    pred = bert.cls.predictions
    return h.float() @ pred.decoder.weight.T + pred.bias
