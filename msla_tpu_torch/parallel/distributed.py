"""The process group of a multi-process run (port of
msla_tpu/parallel/distributed.py:23-94).

The reference's multi-node story is Lightning DDP (`num_nodes`, `devices: -1`
in configs/hparams_search/optuna.yaml:16-17) over NCCL. Here each rank calls
``setup_distributed()`` first thing (``main.main`` does), which reads the
launch's environment and joins the process group: NCCL on the card, one
process a card, gloo when the launcher's ``--platform cpu`` asked for the CPU.
On one process it is a no-op.

The environment is torch's ``env://`` contract (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), which this
package's launcher and ``torchrun`` set, or the JAX package's launcher's
(``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``). The
TPU pod and GKE markers the JAX package reads (``TPU_WORKER_HOSTNAMES``,
``MEGASCALE_COORDINATOR_ADDRESS``) are not: there is no TPU (ROADMAP.md §3).
"""
from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

from msla_tpu_torch.device import resolve_device
from msla_tpu_torch.parallel.mesh import forget_process_rank, group_up, record_process_rank

log = logging.getLogger(__name__)

DEFAULT_MASTER_PORT = "29500"   # torch's env:// default


def _int(value) -> int | None:
    return int(value) if value not in (None, "") else None


def detect_pod_env(env=None) -> dict | None:
    """The launch this process belongs to, from an environment mapping:
    ``coordinator_address`` ("host:port"), ``num_processes``, ``process_id``
    and ``local_rank`` (None where the mapping does not say), or None for a
    run of one process. A pure function, so tests pass stubbed mappings.

    Recognised, in this order:

    1. torch's ``env://`` contract: ``WORLD_SIZE`` with ``MASTER_ADDR``
       (``MASTER_PORT`` 29500 when absent), or ``WORLD_SIZE`` above 1;
       ``RANK``, ``LOCAL_RANK``. A ``MASTER_ADDR`` alone, which some hosts
       set for every process, is no launch;
    2. the JAX launcher's ``JAX_COORDINATOR_ADDRESS``, or ``JAX_NUM_PROCESSES``
       above 1; ``JAX_PROCESS_ID``, and ``LOCAL_RANK`` where it is set.
    """
    env = os.environ if env is None else env
    master, world = env.get("MASTER_ADDR"), _int(env.get("WORLD_SIZE"))
    if world is not None and (master or world > 1):
        port = env.get("MASTER_PORT") or DEFAULT_MASTER_PORT
        return {"coordinator_address": f"{master}:{port}" if master else None,
                "num_processes": world, "process_id": _int(env.get("RANK")),
                "local_rank": _int(env.get("LOCAL_RANK"))}
    coordinator, num = env.get("JAX_COORDINATOR_ADDRESS"), _int(env.get("JAX_NUM_PROCESSES"))
    if coordinator or (num or 1) > 1:
        return {"coordinator_address": coordinator or None, "num_processes": num,
                "process_id": _int(env.get("JAX_PROCESS_ID")),
                "local_rank": _int(env.get("LOCAL_RANK"))}
    return None


def setup_distributed(coordinator_address: str | None = None,
                      num_processes: int | None = None,
                      process_id: int | None = None,
                      local_rank: int | None = None) -> bool:
    """Join the process group; True if this process is one rank of a launch.

    The arguments default to the launch's environment (``detect_pod_env``).
    ``local_rank`` defaults to the rank, one node. On the card the rank's
    device is set (``cuda:local_rank``) before anything is allocated there,
    and the group is NCCL's; a failed NCCL start raises, and nothing falls
    back to gloo. ``MSLA_PLATFORM=cpu`` (the launcher's ``--platform cpu``)
    takes gloo on the CPU. A group already up is kept."""
    if group_up():
        return True
    if coordinator_address or (num_processes or 1) > 1:
        spec = {"coordinator_address": coordinator_address, "num_processes": num_processes,
                "process_id": process_id, "local_rank": local_rank}
    else:
        spec = detect_pod_env()
        if spec is None:
            return False
    coordinator, world, rank = (spec["coordinator_address"], spec["num_processes"],
                                spec["process_id"])
    if coordinator is None or world is None or rank is None:
        raise RuntimeError(f"a multi-process launch needs a coordinator, a world size and a "
                           f"rank, and this one gives {spec}: start the ranks with python -m "
                           "msla_tpu_torch.parallel.launch (or torchrun)")
    local = rank if spec["local_rank"] is None else spec["local_rank"]
    kw = {}
    if os.environ.get("MSLA_PLATFORM") == "cpu":
        backend = "gloo"
    else:
        backend = "nccl"
        resolve_device("cuda")
        torch.cuda.set_device(local)   # before anything allocates on the card
        kw["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", world_size=world,
                            rank=rank, **kw)
    record_process_rank(rank, world)
    log.info("Process group up: %s, rank %d of %d (local rank %d)", backend, rank, world, local)
    return True


def teardown_distributed() -> None:
    """Leave the process group, if one is up, and forget the rank."""
    if group_up():
        dist.destroy_process_group()
    forget_process_rank()
