"""The rank grid and the data axis (port of msla_tpu/parallel/mesh.py:27-69,
253-340): who this process is, which device it drives, and the collectives
of data parallelism.

The JAX package puts every device of the job on one mesh, and its jitted step
sees the global batch, whose shards the processes feed
(``make_array_from_process_local_data``); XLA inserts the gradient's
all-reduce. Here one process drives one card (``cuda:LOCAL_RANK``), its
batch is its shard of the global batch (the rank's rows, the loader's
interleave), and the collectives are explicit.

**The rank grid** (``make_grid``, after ``make_mesh``, mesh.py:60-69): the
world is dp × mp ranks, rank r the data index r // mp and the model index
r % mp, as ``np.asarray(devs).reshape(n // mp, mp)`` lays the devices out.
The model axis is ``model_parallel`` wide, or ``pipeline_parallel`` wide
when that is the one set (msla_tpu/train/trainer.py:158-161); under the
pipeline a rank's model index is its stage, and its model group holds the
stages in order (``RankGrid.model_peer``, ``parallel/pipeline.py``).
The ranks of one data index (model peers) hold the same batch rows; the
ranks of one model index form a data group. ``Trainer`` runs its loops
``on_grid(grid)``, and there the data axis below means the data group:

* ``mean_gradients``: after a step's backward, the mean over the data group
  of the gradient, as one flat all-reduce;
* ``all_sum``, ``all_max``, ``all_sum_autograd``: the reductions over the
  global batch that a task computes in its step (the VQ's code counts, the
  largest BERT id, the MoE's load-balance sums). They reduce only inside
  ``data_axis()``, where the Trainer runs its steps; elsewhere (generation,
  plots, a serving call on rank 0 alone) the batch is the process's own;
* ``gather_rows``: every data index's rows of a predict batch, data-major;
* ``data_info``: (data index, dp), by which the loaders interleave the data
  and the augment takes its rows' masks;
* ``broadcast_object``: rank 0's value on every rank (the sweep's directory,
  widths and values under the launcher).

Outside a grid the data axis is the world, as data parallelism alone has it; at
model_parallel 1 the grid's data group is the world itself. Each collective
is a no-op without a process group. With one, at world size 1 (one card),
they run and leave every value as it was: a sum over one rank, a division
by 1. ``ModelAxis`` carries the model group's two collectives of
Megatron's pattern for the modules that compute on their shards
(``parallel/sharding.py``).

``batch_sharding``, ``replicated``, ``shard_batch`` and ``shard_stacked`` have
no counterpart under one process a card: each rank feeds its own batch.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from msla_tpu_torch.device import resolve_device

LAUNCHER = "python -m msla_tpu_torch.parallel.launch --nproc <devices> -- ..."

_recorded_rank: int | None = None
_recorded_count: int | None = None
_sharded = False
_grids: dict[int, "RankGrid"] = {}   # by model_parallel, for the process group that is up
_active: "RankGrid | None" = None    # the grid of the Trainer's loop that is running


def group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def record_process_rank(rank: int, count: int) -> None:
    """Record this process's rank and the world size (``setup_distributed``
    does, once the group is up)."""
    global _recorded_rank, _recorded_count
    _recorded_rank, _recorded_count = int(rank), int(count)


def forget_process_rank() -> None:
    """Forget the rank, and the grids built on the group that is leaving."""
    global _recorded_rank, _recorded_count, _active
    _recorded_rank = _recorded_count = None
    _grids.clear()
    _active = None


def process_info() -> tuple[int, int]:
    """(rank, world size): the process group's once it is up, else the
    recorded pair, else one process, (0, 1). The loaders interleave the
    dataset by it (the DistributedSampler's role)."""
    if group_up():
        return dist.get_rank(), dist.get_world_size()
    if _recorded_rank is not None and _recorded_count is not None:
        return _recorded_rank, _recorded_count
    return 0, 1


def is_main_process() -> bool:
    """True on the rank that writes the run's files (rank 0).

    Before any group is up, the launch's environment answers (``RANK``, or
    the JAX launcher's ``JAX_PROCESS_INDEX`` / ``JAX_PROCESS_ID``); a launch
    that names a coordinator or several processes but no rank raises, since
    every process would take itself for rank 0 and race the writes."""
    if group_up() or _recorded_rank is not None:
        return process_info()[0] == 0
    for var in ("RANK", "JAX_PROCESS_INDEX", "JAX_PROCESS_ID"):
        if os.environ.get(var):
            return int(os.environ[var]) == 0
    hints = [k for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES") if os.environ.get(k)]
    if int(os.environ.get("WORLD_SIZE") or 1) > 1:
        hints.append("WORLD_SIZE")
    if hints:
        raise RuntimeError(
            "is_main_process called before setup_distributed on what looks like a "
            f"multi-process launch ({','.join(hints)} set) but no rank is known: call "
            "setup_distributed() first or set RANK")
    return True


def resolve_devices(accelerator: str = "gpu", devices=-1, num_nodes: int = 1) -> torch.device:
    """The device this rank drives, after holding the Trainer's ``devices`` and
    ``num_nodes`` to the process group (Lightning's meaning, after
    msla_tpu/parallel/mesh.py:27-57: ``devices`` counts the ranks of a node,
    one a card; -1 any number of them). ``devices`` × ``num_nodes`` must be
    the world size, which only the launcher makes more than 1."""
    rank, world = process_info()
    nodes = max(1, int(num_nodes or 1))
    if devices in (None, -1, "auto", "-1"):
        want, fits = f"a multiple of num_nodes={nodes}", world % nodes == 0
    else:
        want = int(devices) * nodes
        fits = want == world
    if not fits:
        raise ValueError(
            f"Trainer(devices={devices!r}, num_nodes={num_nodes!r}) asks for {want} ranks, "
            f"and this process is rank {rank} of {world}: start one process a device "
            f"with {LAUNCHER}")
    if accelerator == "cpu":
        device = torch.device("cpu")
    else:
        resolve_device("cuda")
        device = torch.device("cuda", torch.cuda.current_device())
    if group_up():
        backend, need = dist.get_backend(), "gloo" if device.type == "cpu" else "nccl"
        if backend != need:
            raise ValueError(f"the process group runs {backend} and the Trainer runs on "
                             f"{device.type}, which needs {need}: launch with --platform cpu "
                             "for the CPU, without it for the card")
    return device


@dataclass(frozen=True)
class RankGrid:
    """This rank's place on the (data, model) grid and the groups of its two
    axes. At model_parallel 1, ``data_group`` None is the world, and no leaf
    lies on the model axis, which has no group."""
    dp: int
    mp: int
    data_index: int
    model_index: int
    data_group: Any
    model_group: Any

    def axis(self, name: str) -> tuple[Any, int, int]:
        """(group, this rank's index on it, its size) of "data" or "model"."""
        if name == "data":
            return self.data_group, self.data_index, self.dp
        return self.model_group, self.model_index, self.mp

    def model_peer(self, index: int) -> int:
        """The global rank of this rank's model peer at model index ``index``:
        under ``pipeline_parallel`` the model index is the stage, so
        ``model_peer(model_index ∓ 1)`` are the previous and the next stage."""
        return self.data_index * self.mp + index


def make_grid(model_parallel: int = 1) -> RankGrid | None:
    """The (data, model) grid of the process group, None without one (the
    one-process path). A world that ``model_parallel`` does not divide raises
    JAX's ``ValueError`` (msla_tpu/parallel/mesh.py:65-67), a lone process
    too (a world of 1). Every rank builds every group, in one order (the
    model groups, then the data groups): ``dist.new_group`` is collective,
    and ranks that build them in different orders wait on each other for
    ever. A grid is built once a process group and ``model_parallel``."""
    mp = max(1, int(model_parallel))
    rank, world = process_info()
    if world % mp:
        raise ValueError(f"{world} devices not divisible by the model-axis size {mp} (set via "
                         "model_parallel or pipeline_parallel)")
    if not group_up():
        return None
    if mp not in _grids:
        dp = world // mp
        model_group = data_group = None   # at mp 1: the world's, and no model axis
        if mp > 1:
            for i in range(dp):
                group = dist.new_group([i * mp + j for j in range(mp)])
                if rank // mp == i:
                    model_group = group
            for j in range(mp):
                group = dist.new_group([i * mp + j for i in range(dp)])
                if rank % mp == j:
                    data_group = group
        _grids[mp] = RankGrid(dp, mp, rank // mp, rank % mp, data_group, model_group)
    return _grids[mp]


@contextmanager
def on_grid(grid: RankGrid | None):
    """Inside: the data axis is ``grid``'s data group (the world when None)."""
    global _active
    before, _active = _active, grid
    try:
        yield
    finally:
        _active = before


def _data_axis() -> tuple[Any, int, int]:
    if _active is not None:
        return _active.axis("data")
    rank, world = process_info()
    return None, rank, world


def data_info() -> tuple[int, int]:
    """(data index, data size): the rank and the world outside a grid. The
    loaders interleave the data by it and the augment takes its rows' masks:
    model peers read the same rows."""
    _, index, size = _data_axis()
    return index, size


@contextmanager
def data_axis():
    """Inside: the batch a task sees is this rank's shard of the global batch,
    so ``all_sum``, ``all_max`` and ``all_sum_autograd`` reduce over the ranks."""
    global _sharded
    before, _sharded = _sharded, True
    try:
        yield
    finally:
        _sharded = before


def sharded() -> bool:
    return _sharded and group_up()


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """Σ over the ranks of ``t`` inside ``data_axis()``, a new tensor, queued
    on the stream (no wait on the host); ``t`` itself elsewhere."""
    if not sharded():
        return t
    t = t.clone()
    dist.all_reduce(t, group=_data_axis()[0])
    return t


def all_max(t: torch.Tensor) -> torch.Tensor:
    """The largest over the ranks of ``t`` inside ``data_axis()``; ``t`` elsewhere."""
    if not sharded():
        return t
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_data_axis()[0])
    return t


def all_sum_autograd(t: torch.Tensor) -> torch.Tensor:
    """``all_sum`` through which gradients flow: the backward sums the data
    group's gradients. Every rank's loss holds the same global value, so each
    rank's gradient is the data size times its rows' share, which
    ``mean_gradients``' division takes back out."""
    if not sharded():
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, group=_data_axis()[0])


def mean_gradients(params) -> None:
    """Each parameter's gradient replaced by its mean over the data axis: one
    flat all-reduce, then a division by the data size. A parameter with no
    gradient keeps none (so Adam skips it on every rank alike)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not group_up() or not grads:
        return
    group, _, size = _data_axis()
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= size
    for g, mean in zip(grads, torch.split(flat, [g.numel() for g in grads])):
        g.copy_(mean.view_as(g))


def gather_rows(out: torch.Tensor) -> torch.Tensor:
    """Every data index's ``out`` with their rows concatenated along dim 0,
    data-major, on every rank (model peers hold the same rows)."""
    if not group_up():
        return out
    group, _, size = _data_axis()
    parts = [torch.empty_like(out) for _ in range(size)]
    dist.all_gather(parts, out.contiguous(), group=group)
    return torch.cat(parts)


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` on every rank (a picklable value); ``obj`` itself
    without a process group."""
    if not group_up():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def barrier() -> None:
    if not group_up():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


class _EnterModel(torch.autograd.Function):
    """Megatron's f: the identity forward into a part that the model peers
    compute on their shards; the backward sums the peers' gradients, each of
    which holds only its shard's share."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.clone()

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceModel(torch.autograd.Function):
    """Megatron's g: the sum of the model peers' partial outputs; the
    backward passes the gradient through, since every peer holds the same
    one. (``torch.distributed.nn.functional.all_reduce`` sums it, which would
    scale it by the model size.)"""

    @staticmethod
    def forward(ctx, t, group):
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None


class ModelAxis(NamedTuple):
    """A rank's place on the model axis, for a module that computes on its
    shards (the transformer's FFN, the MoE's experts): ``enter`` before the
    part that runs on the shards, ``reduce`` to sum the peers' parts."""
    group: Any
    index: int
    size: int

    def enter(self, t: torch.Tensor) -> torch.Tensor:
        return _EnterModel.apply(t, self.group)

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        return _ReduceModel.apply(t, self.group)
