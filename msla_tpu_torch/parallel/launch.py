"""Start the ranks of a data-parallel run (port of msla_tpu/parallel/launch.py):

    python -m msla_tpu_torch.parallel.launch --nproc 2 -- -m msla_tpu_torch train_vqvae=True
    python -m msla_tpu_torch.parallel.launch --nproc 2 --platform cpu -- script.py [args]

spawns ``--nproc`` copies of ``python <cmd>`` with torch's ``env://``
contract set (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), which ``setup_distributed`` (the first
thing ``msla_tpu_torch.main.main`` does) reads to join the process group. On
the card each rank drives ``cuda:LOCAL_RANK``; ``--platform cpu`` runs gloo on
the CPU. Every line a rank prints, its errors included, comes out prefixed
``[rank N]``. The launcher's exit code is the first non-zero exit code of a
rank; once a rank fails the others are stopped (they would wait for it in
their next collective).

Over several hosts the launcher runs once a host with ``--nnodes`` and
``--node-rank`` (a rank's rank is node_rank · nproc + local rank) and one
``--coordinator host:port`` of node 0, which node 0 listens on; torchrun's
``--node_rank`` / ``--master_addr`` contract.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import threading
import time

STOP_GRACE_S = 5.0


def _free_port() -> int:
    # the port is released before rank 0 binds it, so another program could
    # take it meanwhile (torchrun's pattern shares this); --coordinator avoids it
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _stream(proc: subprocess.Popen, rank: int) -> None:
    for line in proc.stdout:  # type: ignore[union-attr]
        sys.stdout.write(f"[rank {rank}] {line}")
        sys.stdout.flush()


def _stop(procs: list[subprocess.Popen]) -> None:
    """SIGTERM to every rank still running, SIGKILL to those that outlast the grace."""
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + STOP_GRACE_S
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def rank_env(base: dict, coordinator: str, world: int, rank: int, local_rank: int,
             nproc: int, platform: str | None) -> dict:
    host, port = coordinator.rsplit(":", 1)
    env = dict(base, MASTER_ADDR=host, MASTER_PORT=port, WORLD_SIZE=str(world),
               RANK=str(rank), LOCAL_RANK=str(local_rank), LOCAL_WORLD_SIZE=str(nproc),
               PYTHONUNBUFFERED="1")
    if platform:
        env["MSLA_PLATFORM"] = platform
    return env


def _interrupted(signum, frame):
    raise KeyboardInterrupt


def launch(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m msla_tpu_torch.parallel.launch",
        description="Start N ranks of a torch.distributed run, one a device")
    parser.add_argument("--nproc", type=int, default=1, help="ranks on this host")
    parser.add_argument("--nnodes", type=int, default=1, help="hosts in the job")
    parser.add_argument("--node-rank", type=int, default=0, help="this host's index")
    parser.add_argument("--coordinator", default=None,
                        help="host:port of rank 0 (default: localhost:<a free port>)")
    parser.add_argument("--platform", default=None,
                        help="cpu: gloo on the CPU; otherwise NCCL on the card")
    parser.add_argument("cmd", nargs=argparse.REMAINDER,
                        help="-- script.py [args] | -- -m module [args]")
    args = parser.parse_args(argv)

    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        parser.error("no command given (usage: ... --nproc 2 -- -m msla_tpu_torch [overrides])")
    if args.nproc < 1 or args.nnodes < 1 or not 0 <= args.node_rank < args.nnodes:
        parser.error(f"--nproc {args.nproc}, --nnodes {args.nnodes}, --node-rank "
                     f"{args.node_rank}: need nproc, nnodes >= 1 and 0 <= node-rank < nnodes")
    if args.coordinator is None:
        if args.node_rank > 0:
            parser.error("--coordinator is required when --node-rank > 0")
        args.coordinator = f"localhost:{_free_port()}"

    world = args.nproc * args.nnodes
    procs: list[subprocess.Popen] = []
    threads: list[threading.Thread] = []
    for local_rank in range(args.nproc):
        rank = args.node_rank * args.nproc + local_rank
        env = rank_env(os.environ, args.coordinator, world, rank, local_rank, args.nproc,
                       args.platform)
        p = subprocess.Popen([sys.executable, *cmd], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL, text=True)
        procs.append(p)
        t = threading.Thread(target=_stream, args=(p, rank), daemon=True)
        t.start()
        threads.append(t)

    rc = 0
    try:
        while None in [p.poll() for p in procs]:   # every rank polled each turn
            failed = [p.returncode for p in procs if p.returncode not in (None, 0)]
            if failed:
                rc = failed[0]
                _stop(procs)
                break
            time.sleep(0.05)
        if rc == 0:
            rc = next((p.returncode for p in procs if p.returncode != 0), 0)
    except KeyboardInterrupt:  # pragma: no cover - interactive, or SIGTERM
        _stop(procs)
        rc = 130
    for t in threads:
        t.join(timeout=5)
    return rc


if __name__ == "__main__":
    signal.signal(signal.SIGTERM, _interrupted)   # stopped, the launcher stops its ranks
    sys.exit(launch())
