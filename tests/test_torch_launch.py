"""The port's launcher, ``python -m msla_tpu_torch.parallel.launch``, after
tests/test_launch.py: the ranks' environment and ``[rank N]`` prefixes, the
first non-zero exit code (the other ranks stopped), the two-node contract
(``--nnodes``, ``--node-rank``, ``--coordinator``), and one 4-rank gloo run
in which the loaders' shards are disjoint and cover the dataset and every
rank ends a ``Trainer.fit`` step with the same loss and weights.
"""
import os
import re
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

from msla_tpu_torch.parallel.launch import launch

REPO = Path(__file__).resolve().parent.parent
ENV = {**os.environ, "PYTHONPATH": f"{REPO}{os.pathsep}{REPO / 'tests'}",
       "OMP_NUM_THREADS": "1"}

PROBE = textwrap.dedent("""
    import os, sys, time
    rank = int(os.environ["RANK"])
    print(f"rank={rank} world={os.environ['WORLD_SIZE']} local={os.environ['LOCAL_RANK']} "
          f"of={os.environ['LOCAL_WORLD_SIZE']} master={os.environ['MASTER_ADDR']} "
          f"platform={os.environ.get('MSLA_PLATFORM')}", flush=True)
    print("second line", flush=True)
    fail = {int(k): int(v) for k, v in (a.split("=") for a in sys.argv[1:])}
    if rank in fail:
        sys.exit(fail[rank])
    time.sleep(0 if not fail else 60)
""")

GROUP = textwrap.dedent("""
    import torch, torch.distributed as dist
    from msla_tpu_torch.parallel.distributed import setup_distributed, teardown_distributed
    from msla_tpu_torch.parallel.mesh import is_main_process, process_info
    assert setup_distributed()
    t = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(t)
    print(f"rank={process_info()} main={is_main_process()} sum={t.item()}", flush=True)
    teardown_distributed()
""")

FOUR = textwrap.dedent("""
    import pathlib, sys
    import numpy as np, torch
    from _torch_dp import B, CFG, ArrayDataModule, vqvae_task
    from msla_tpu_torch.data.loader import DataLoader
    from msla_tpu_torch.parallel.distributed import setup_distributed, teardown_distributed
    from msla_tpu_torch.parallel.mesh import process_info
    from msla_tpu_torch.train.trainer import Trainer
    from msla_tpu_torch.models.vqvae import VQVAETask

    torch.set_num_threads(1)
    assert setup_distributed()
    r, n = process_info()
    fed = np.concatenate([b[:, 0] for b in DataLoader(
        np.arange(16)[:, None], batch_size=2, shuffle=True, seed=11,
        process_index=r, process_count=n)])
    print(f"FED rank={r} idx={sorted(int(i) for i in fed)}", flush=True)

    rng = np.random.default_rng(7)   # the same global data on every rank
    splits = {s: (rng.standard_normal((n * B, 4, 800)) * 0.3).astype(np.float32)
              for s in ("train", "val")}
    out = pathlib.Path(sys.argv[1])
    init = VQVAETask(**CFG, checkpoint_dir=str(out), codebook_file=str(out / "cb.csv"),
                     device="cpu", seed=0).net.state_dict()
    task = vqvae_task(init, out)
    trainer = Trainer(max_epochs=1, accelerator="cpu", enable_progress_bar=False, seed=0)
    trainer.fit(task, ArrayDataModule(splits, B))
    total = sum(float(v.double().sum()) for v in task.net.state_dict().values())
    print(f"LOSS rank={r} loss={trainer.callback_metrics['train/loss']!r} "
          f"weights={total!r}", flush=True)
    teardown_distributed()
""")


def _run(tmp_path, script: str, *args: str, nproc: int = 2, extra=(), timeout=120):
    path = tmp_path / "probe.py"
    path.write_text(script)
    return subprocess.run(
        [sys.executable, "-m", "msla_tpu_torch.parallel.launch", "--nproc", str(nproc),
         *extra, "--", str(path), *args],
        capture_output=True, text=True, timeout=timeout, env=ENV, cwd=REPO)


def test_two_ranks_get_their_environment_and_prefixes(tmp_path):
    proc = _run(tmp_path, PROBE, extra=("--platform", "cpu"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 4 and all(re.match(r"\[rank [01]\] ", line) for line in lines), lines
    for r in (0, 1):
        assert (f"[rank {r}] rank={r} world=2 local={r} of=2 master=localhost "
                "platform=cpu") in lines
        assert f"[rank {r}] second line" in lines


def test_the_first_failing_rank_gives_the_exit_code_and_stops_the_rest(tmp_path):
    t0 = time.perf_counter()
    proc = _run(tmp_path, PROBE, "1=3")
    assert proc.returncode == 3, proc.stdout + proc.stderr
    assert time.perf_counter() - t0 < 30   # rank 0, asleep for 60 s, was stopped


def test_a_node_other_than_the_first_needs_the_coordinator():
    with pytest.raises(SystemExit) as err:
        launch(["--nproc", "1", "--nnodes", "2", "--node-rank", "1", "--", "x.py"])
    assert err.value.code == 2


def test_two_nodes_form_one_group(tmp_path):
    """One launcher a node, each with one rank; rank = node_rank · nproc + local."""
    path = tmp_path / "group.py"
    path.write_text(GROUP)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    nodes = [subprocess.Popen(
        [sys.executable, "-m", "msla_tpu_torch.parallel.launch", "--nproc", "1", "--nnodes",
         "2", "--node-rank", str(node), "--coordinator", f"localhost:{port}", "--platform",
         "cpu", "--", str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=ENV, cwd=REPO) for node in (0, 1)]
    outs = [p.communicate(timeout=120)[0] for p in nodes]
    assert all(p.returncode == 0 for p in nodes), outs
    assert "[rank 0] rank=(0, 2) main=True sum=3.0" in outs[0]
    assert "[rank 1] rank=(1, 2) main=False sum=3.0" in outs[1]


def test_four_ranks_feed_disjoint_shards_and_end_alike(tmp_path):
    proc = _run(tmp_path, FOUR, str(tmp_path), nproc=4, extra=("--platform", "cpu"),
                timeout=300)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
    fed = {r: eval(idx) for r, idx in re.findall(r"FED rank=(\d) idx=(\[[^\]]*\])",
                                                  proc.stdout)}
    assert sorted(fed) == ["0", "1", "2", "3"], proc.stdout
    every = [i for idx in fed.values() for i in idx]
    assert len(every) == 16 and set(every) == set(range(16))
    ends = set(re.findall(r"LOSS rank=\d loss=(\S+) weights=(\S+)", proc.stdout))
    assert len(re.findall(r"LOSS rank=", proc.stdout)) == 4 and len(ends) == 1, proc.stdout
