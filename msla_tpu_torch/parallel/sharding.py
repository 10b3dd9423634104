"""Sharded state over the (data, model) grid: the model axis's layouts and the
step that keeps them (port of msla_tpu/parallel/mesh.py:83-192, 235-250 and the
sharded half of msla_tpu/train/trainer.py:173-235, 309-341, 396-418).

**The layout rules** give each parameter a spec, one entry a dim: "model",
"data" or None (whole), as JAX's ``PartitionSpec`` over the mesh's axes.
They are JAX's rules written for the port's tensors, which hold flax's leaves
under ``utils/jax_compat.py``'s map: a flax kernel (``Dense`` (in, out),
``Conv`` (W, in, out), ``ConvTranspose`` (W, out, in)) is a torch weight
(``Linear``, ``Conv1d``, ``ConvTranspose1d``) with its axes reversed; the
codebook, the MoE's stacks, biases and norms keep their layout. So:

* ``tp_param_spec`` (mesh.py:83-109): the codebook's rows, and the MoE's
  ``w1``/``b1``/``w2``/``b2`` on their expert dim, over "model"; the FFN's
  ``linear1`` column-parallel (torch dim 0, flax's last) and ``linear2``
  row-parallel (torch dim 1, flax's first); a 3-D kernel of 64 or more
  channels on flax's last dim, torch's dim 0 (the out-channels of a conv,
  the in-channels of a transposed conv). Only where the dim divides the
  axis; the rest stays whole;
* ``split_over_data`` (mesh.py:112-128): the largest free dim the data size
  divides goes over "data", ties to the first in flax's order (a kernel's
  last in torch's). ``fsdp`` applies it to the parameters, ``zero1`` to the
  Adam moments; under ``fsdp`` the moments mirror the parameters and are not
  split twice.

Under ``pipeline_parallel`` the model axis holds the pipeline's stages and
the tp rules stay off it (``ShardedState(tensor_parallel=False)``): every
parameter is whole, as JAX replicates them under pp, and only ``zero1``
splits the moments over the data group.

JAX applies ``split_over_data`` only where the data axis is wider than one
device (mesh.py:146-147, 184). The port applies it at any width: a group of
one rank holds a leaf in one part, which places it as the whole does, and
the sharded path runs its gathers and slices over that group all the same.
Tensor parallelism needs ``model_parallel`` > 1, as in JAX.

**The step** (``ShardedState``). Each rank keeps only its block of a sharded
parameter (``held``) and of its Adam moments, for as long as the Trainer's
loop runs; the net's ``Parameter`` objects stay the optimizer's, their
``.data`` swapped between three forms:

* in use (``use()``: a train step, an evaluation, predict): gathered whole
  over "data" (FSDP) and over "model" (the leaves a hand-written kernel or a
  cuDNN conv reads, as XLA gathers around a Pallas call, so a kernel sees
  data parallelism's weights and inputs) — except the leaves of a module that computes
  on its shards (``model_sharded``: the FFN's linears, the MoE's experts),
  which stay split over "model" and run Megatron's pattern through the
  module's ``ModelAxis``;
* in the optimizer step (``step``): after the gradient's mean over the data
  group (``mesh.mean_gradients``, one flat all-reduce), each gradient is
  sliced to this rank's block of the moments; Adam updates that block of the
  parameter; the blocks are then all-gathered over the data group (ZeRO-1).
  The mean is an all-reduce and a slice, one implementation for gloo and
  NCCL (gloo lacks ``reduce_scatter``);
* held, between them.

Outside the loop (``unshard``) the net holds whole tensors again and its
modules compute as one process does. ``whole_state`` gathers the weights and
moments to the unsharded run's tensors on every rank (a checkpoint's; the
gather is collective, so every rank calls it before rank 0's write gate), and
``load_whole`` slices such a state onto this layout, whatever layout wrote it.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
from torch import nn

from msla_tpu_torch.parallel.mesh import ModelAxis, RankGrid

DATA, MODEL = "data", "model"
BOTH = frozenset((DATA, MODEL))
Spec = tuple   # one entry a dim: DATA, MODEL or None


# ---- layout rules ---------------------------------------------------------------------

def tp_param_spec(name: str, shape: tuple, kernel: bool, mp: int) -> Spec:
    """The tensor-parallel spec of the port's parameter ``name`` (a flax
    kernel when ``kernel``), msla_tpu/parallel/mesh.py:83-109's rules."""
    keys, nd = name.split("."), len(shape)
    whole = (None,) * nd
    if "moe" in keys and keys[-1] in ("w1", "b1", "w2", "b2") and shape[0] % mp == 0:
        return (MODEL,) + whole[1:]
    if "codebook" in keys and nd == 2 and shape[0] % mp == 0:
        return (MODEL, None)
    if kernel and nd == 2:
        if any(k.startswith("linear1") for k in keys) and shape[0] % mp == 0:
            return (MODEL, None)      # column parallel: flax's P(None, "model")
        if any(k.startswith("linear2") for k in keys) and shape[1] % mp == 0:
            return (None, MODEL)      # row parallel: flax's P("model", None)
    if kernel and nd == 3 and shape[0] >= 64 and shape[0] % mp == 0:
        return (MODEL, None, None)    # flax's P(None, None, "model")
    return whole


def split_over_data(spec: Spec, shape: tuple, dp: int, kernel: bool = False) -> Spec:
    """``spec`` with its largest free dim that ``dp`` divides over "data"
    (ties: the first in flax's order), or as it is where it already uses
    "data" or no free dim divides."""
    if DATA in spec:
        return spec
    best = None
    for i in (reversed(range(len(shape))) if kernel else range(len(shape))):
        if spec[i] is None and shape[i] % dp == 0 and (best is None or shape[i] > shape[best]):
            best = i
    if best is None:
        return spec
    return tuple(DATA if i == best else a for i, a in enumerate(spec))


def param_spec(name: str, shape: tuple, kernel: bool, mp: int, dp: int,
               fsdp: bool = False) -> Spec:
    """A parameter's layout (``make_param_shardings``, mesh.py:131-156)."""
    spec = tp_param_spec(name, shape, kernel, mp) if mp > 1 else (None,) * len(shape)
    return split_over_data(spec, shape, dp, kernel) if fsdp else spec


def opt_spec(spec: Spec, shape: tuple, kernel: bool, dp: int, zero1: bool = False) -> Spec:
    """Its Adam moments' layout (``make_opt_shardings``, mesh.py:159-192)."""
    return split_over_data(spec, shape, dp, kernel) if zero1 else spec


def kernel_names(net: nn.Module) -> set[str]:
    """The parameters that hold a flax kernel: the weights of the Linear and
    Conv modules."""
    kinds = (nn.Linear, nn.Conv1d, nn.ConvTranspose1d)
    return {f"{m}.weight" if m else "weight" for m, mod in net.named_modules()
            if isinstance(mod, kinds)}


# ---- the sharded state ------------------------------------------------------------------

@dataclass
class _Leaf:
    p: nn.Parameter
    shape: tuple          # whole
    spec: Spec            # the parameter's layout
    opt: Spec             # its moments'
    compute: frozenset = frozenset()   # the axes its module computes on the shards of
    held: torch.Tensor | None = None
    opt_only: Spec = field(init=False)   # the dims the moments split further (zero1)

    def __post_init__(self):
        self.opt_only = tuple(o if o != s else None for o, s in zip(self.opt, self.spec))


class ShardedState:
    """A net's parameters on ``grid``: their layouts, and the forms the step
    swaps them through (the module docstring)."""

    def __init__(self, net: nn.Module, grid: RankGrid, zero1: bool = False, fsdp: bool = False,
                 tensor_parallel: bool = True):
        """``tensor_parallel`` False keeps the tp rules off the model axis,
        which the pipeline's stages hold (every leaf whole there, as JAX
        replicates the params under pp; ``zero1`` still splits the moments
        over the data group)."""
        self.net, self.grid = net, grid
        kernels = kernel_names(net)
        mp = grid.mp if tensor_parallel else 1
        self.leaves: dict[str, _Leaf] = {}
        for name, p in net.named_parameters():
            shape, kernel = tuple(p.shape), name in kernels
            spec = param_spec(name, shape, kernel, mp, grid.dp, fsdp)
            self.leaves[name] = _Leaf(p, shape, spec, opt_spec(spec, shape, kernel, grid.dp, zero1))
        self.by_id = {id(leaf.p): leaf for leaf in self.leaves.values()}
        self.modules: list[nn.Module] = []
        for prefix, module in net.named_modules():
            names = [f"{prefix}.{n}" if prefix else n for n in getattr(module, "model_sharded", ())]
            split = [MODEL in self.leaves[n].spec for n in names]
            if any(split):
                if not all(split):
                    raise ValueError(f"{prefix}: {names} split over the model axis in part only")
                for n in names:
                    self.leaves[n].compute = frozenset((MODEL,))
                self.modules.append(module)
        self.active = False

    # blocks of a tensor along the grid's axes
    def _take(self, t: torch.Tensor, spec: Spec, axes) -> torch.Tensor:
        for d, a in enumerate(spec):
            if a in axes:
                _, index, size = self.grid.axis(a)
                n = t.shape[d] // size
                t = t.narrow(d, index * n, n)
        return t

    def _gather(self, t: torch.Tensor, spec: Spec, axes) -> torch.Tensor:
        for d, a in enumerate(spec):
            if a in axes:
                group, _, size = self.grid.axis(a)
                t = t.contiguous()
                parts = [torch.empty_like(t) for _ in range(size)]
                dist.all_gather(parts, t, group=group)
                t = torch.cat(parts, dim=d)
        return t

    def _set_axes(self, on: bool) -> None:
        _, index, size = self.grid.axis(MODEL)
        for module in self.modules:
            module.model_axis = ModelAxis(self.grid.model_group, index, size) if on else None

    def shard(self) -> None:
        """Whole tensors → this rank's blocks (the Trainer's loop starts)."""
        if self.active:
            return
        for leaf in self.leaves.values():
            leaf.held = self._take(leaf.p.data, leaf.spec, BOTH).clone()
            leaf.p.data = leaf.held
        self._set_axes(True)
        self.active = True

    def unshard(self) -> None:
        """Blocks → whole tensors on every rank (collective; the loop ends)."""
        if not self.active:
            return
        for leaf in self.leaves.values():
            leaf.p.data = self._gather(leaf.held, leaf.spec, BOTH)
            leaf.held = None
        self._set_axes(False)
        self.active = False

    @contextmanager
    def use(self):
        """Inside: each parameter in its use form (gathered but on the axes
        its module computes on the shards of)."""
        for leaf in self.leaves.values():
            leaf.p.data = self._gather(leaf.held, leaf.spec, BOTH - leaf.compute)
        try:
            yield
        finally:
            for leaf in self.leaves.values():
                leaf.p.data = leaf.held

    @contextmanager
    def whole(self):
        """Inside: whole tensors, and modules that compute as one process
        does (what a task's hook may read); a no-op outside the loop."""
        if not self.active:
            yield
            return
        for leaf in self.leaves.values():
            leaf.p.data = self._gather(leaf.held, leaf.spec, BOTH)
        self._set_axes(False)
        try:
            yield
        finally:
            for leaf in self.leaves.values():
                leaf.p.data = leaf.held
            self._set_axes(True)

    def step(self, optimizer: torch.optim.Optimizer) -> None:
        """Adam on this rank's blocks, inside ``use()`` after the gradient's
        mean over the data group: each gradient sliced to the moments'
        block, each parameter to it too, then the blocks the moments split
        further (zero1) all-gathered over the data group."""
        stepped = [leaf for leaf in self.leaves.values() if leaf.p.grad is not None]
        for leaf in stepped:   # a leaf with no gradient stays as it is held
            grad, leaf.p.grad = leaf.p.grad, None
            leaf.p.data = self._take(leaf.held, leaf.opt_only, BOTH).clone() \
                if DATA in leaf.opt_only else leaf.held
            leaf.p.grad = self._take(grad, leaf.opt, BOTH - leaf.compute).contiguous()
        optimizer.step()
        for leaf in stepped:
            if DATA in leaf.opt_only:
                leaf.held = self._gather(leaf.p.data, leaf.opt_only, BOTH)
            leaf.p.data = leaf.held

    def _order(self, optimizer) -> list[nn.Parameter]:
        return [p for group in optimizer.param_groups for p in group["params"]]

    def _moments(self, opt_state: dict, optimizer, fn) -> dict:
        """``opt_state`` with ``fn(tensor, leaf)`` on each moment tensor (a
        state tensor of one or more dims; ``step`` is a scalar)."""
        order = self._order(optimizer)
        state = {}
        for index, entry in opt_state["state"].items():
            leaf = self.by_id[id(order[int(index)])]
            state[index] = {k: fn(v, leaf) if torch.is_tensor(v) and v.dim() > 0 else v
                            for k, v in entry.items()}
        return {"state": state, "param_groups": opt_state["param_groups"]}

    def whole_state(self, optimizer: torch.optim.Optimizer | None
                    ) -> tuple[dict[str, torch.Tensor], dict | None]:
        """(the net's state_dict, the optimizer's state_dict, None without
        one) of whole tensors, the keys and shapes of the unsharded run's, on
        every rank. Collective."""
        with self.whole():
            state_dict = self.net.state_dict()
        if optimizer is None:
            return state_dict, None
        return state_dict, self._moments(optimizer.state_dict(), optimizer,
                                         lambda t, leaf: self._gather(t, leaf.opt, BOTH))

    def load_whole(self, state_dict, optimizer: torch.optim.Optimizer | None = None,
                   opt_state: dict | None = None) -> None:
        """Whole tensors (a checkpoint's, any layout's) → this rank's blocks
        (inside the loop): ``load_state_dict``'s strict check of keys and
        shapes, then each leaf sliced; the moments sliced likewise."""
        for leaf in self.leaves.values():
            leaf.p.data = torch.empty(leaf.shape, dtype=leaf.p.dtype, device=leaf.p.device)
        self.net.load_state_dict(state_dict)
        for leaf in self.leaves.values():
            leaf.held = self._take(leaf.p.data, leaf.spec, BOTH).clone()
            leaf.p.data = leaf.held
        if opt_state:
            optimizer.load_state_dict(self._moments(
                opt_state, optimizer, lambda t, leaf: self._take(t, leaf.opt, BOTH).clone()))
