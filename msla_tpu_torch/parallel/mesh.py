"""The data axis (port of msla_tpu/parallel/mesh.py:27-57, 253-340): who this
process is, which device it drives, and the collectives of data parallelism.

The JAX package puts every device of the job on one mesh, and its jitted step
sees the global batch, whose shards the processes feed
(``make_array_from_process_local_data``); XLA inserts the gradient's
all-reduce. Here one process drives one card (``cuda:LOCAL_RANK``), its
batch is its shard of the global batch (the rank's rows, the loader's
interleave), and the collectives are explicit:

* ``mean_gradients``: after a step's backward, the mean over the ranks of
  the gradient, as one flat all-reduce;
* ``all_sum``, ``all_max``, ``all_sum_autograd``: the reductions over the
  global batch that a task computes in its step (the VQ's code counts, the
  largest BERT id, the MoE's load-balance sums). They reduce only inside
  ``data_axis()``, where the Trainer runs its steps; elsewhere (generation,
  plots, a serving call on rank 0 alone) the batch is the process's own;
* ``gather_rows``: every rank's rows of a predict batch, rank-major;
* ``barrier``.

Each is a no-op without a process group. With one, at world size 1 (one
card), they run and leave every value as it was: a sum over one rank, a
division by 1.

``make_mesh``, ``batch_sharding``, ``tp_param_spec``, ``split_over_data`` and
the ``make_*_shardings`` rules are the model axis (ROADMAP.md queue item 7.2)
or have no counterpart under one process a card.
"""
from __future__ import annotations

import os
from contextlib import contextmanager

import torch
import torch.distributed as dist

from msla_tpu_torch.device import resolve_device

LAUNCHER = "python -m msla_tpu_torch.parallel.launch --nproc <devices> -- ..."

_recorded_rank: int | None = None
_recorded_count: int | None = None
_sharded = False


def group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def record_process_rank(rank: int, count: int) -> None:
    """Record this process's rank and the world size (``setup_distributed``
    does, once the group is up)."""
    global _recorded_rank, _recorded_count
    _recorded_rank, _recorded_count = int(rank), int(count)


def forget_process_rank() -> None:
    global _recorded_rank, _recorded_count
    _recorded_rank = _recorded_count = None


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
    dist.all_reduce(t)
    return t


def all_max(t: torch.Tensor) -> torch.Tensor:
    """The largest over the ranks of ``t`` inside ``data_axis()``; ``t`` elsewhere."""
    if not sharded():
        return t
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t


def all_sum_autograd(t: torch.Tensor) -> torch.Tensor:
    """``all_sum`` through which gradients flow: the backward sums the ranks'
    gradients. Every rank's loss holds the same global value, so each rank's
    gradient is the world size times its rows' share, which
    ``mean_gradients``' division takes back out."""
    if not sharded():
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t)


def mean_gradients(params) -> None:
    """Each parameter's gradient replaced by its mean over the ranks: one flat
    all-reduce, then a division by the world size. A parameter with no
    gradient keeps none (so Adam skips it on every rank alike)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not group_up() or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    for g, mean in zip(grads, torch.split(flat, [g.numel() for g in grads])):
        g.copy_(mean.view_as(g))


def gather_rows(out: torch.Tensor) -> torch.Tensor:
    """Every rank's ``out`` with the ranks' rows concatenated along dim 0,
    rank-major, on every rank."""
    if not group_up():
        return out
    parts = [torch.empty_like(out) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, out.contiguous())
    return torch.cat(parts)


def barrier() -> None:
    if not group_up():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
