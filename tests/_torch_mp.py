"""The ranks of the model-axis tests, and what they share with the tests.

    python -m msla_tpu_torch.parallel.launch --nproc 4 --platform cpu -- \
        tests/_torch_mp.py <dir> model
    python -m msla_tpu_torch.parallel.launch --nproc 2 --platform cpu -- \
        tests/_torch_mp.py <dir> data

Each rank joins the gloo group, reads ``<dir>/inputs.pt`` (written by
``tests/test_torch_model_axis.py``), runs the cases of its launch and writes
what it saw to ``<dir>/<launch><r>.pt``. The transformer's and the MoE's
cases run last, on ``<dir>/late.pt``, which the test writes once the JAX
Trainer has drawn the MoE transformer's init. The 4-rank launch runs the model
axis: (dp, mp) = (4, 1) data parallel, zero1 and fsdp at a rank's batch B;
(2, 2) with ``model_parallel=2``, with fsdp too, at 2B (the same global
batch); predict, the MoE's aux, the MoE and the dense transformer, and the
checkpoints at (2, 2). The 2-rank launch is data parallelism alone at 2B,
which the (2, 2) runs are held to. No JAX here: the tests compare these files
with the JAX package in their own process.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch import nn

from _torch_dp import CFG, PREDICT_BATCH, Recorder, vqvae_task
from msla_tpu_torch.data.datamodule import SlakhDataModule
from msla_tpu_torch.train.callbacks import Callback, ModelCheckpoint
from msla_tpu_torch.train.trainer import Trainer

B = 2                          # a rank's VQ-VAE batch at (4, 1); 2B at (2, 2)
GLOBAL = 4 * B                 # the global batch of every VQ-VAE run
STEPS = 3
TRANSFORMER = dict(sample_rate=64, frame_length=2, learning_rate=1e-3, num_layers=1,
                   num_heads=4, hidden_dim=32, dropout=0.0)
EXPERTS = 4


def stems(n: int, t: int, seed: int, rate: int = CFG["sample_rate"]) -> np.ndarray:
    """A tone a stem at a random pitch and loudness over a random offset
    (``tests/test_torch_parallel.py``'s): the initial codebook takes more than
    one code, so a data rank's perplexity is not the global batch's."""
    rng = np.random.default_rng(seed)
    time = np.arange(t) / rate
    f0, amp = rng.uniform(20, 400, (n, 4, 1)), rng.uniform(0.1, 20, (n, 4, 1))
    return (amp * np.sin(2 * np.pi * f0 * time) + rng.uniform(-3, 3, (n, 4, 1))
            ).astype(np.float32)


class Arrays(SlakhDataModule):
    """The port's datamodule over in-memory (n, 4, T) splits: its loaders are
    the real ones, so each rank reads its data index's interleave."""

    def __init__(self, splits: dict, batch_size: int, sample_rate: int = CFG["sample_rate"],
                 duration: int = 1, **kw):
        super().__init__(train_dir="train", val_dir="val", test_dir="test",
                         target_sample_rate=sample_rate, target_sample_duration=duration,
                         max_duration=120, maximum_dataset_size=100, batch_size=batch_size,
                         num_workers=0, **kw)
        self.splits = splits

    def create_dataset(self, path: str, masking: bool = False):
        return self.splits[path]

    def train_dataloader(self):
        return self._loader(self.splits["train"], batch_size=self.batch_size, shuffle=False,
                            drop_last=True)

    def predict_dataloader(self):
        return self._loader(self.splits["test"], batch_size=PREDICT_BATCH, shuffle=False,
                            drop_last=False)


class Layouts(Callback):
    """What a rank holds while the loop runs: each parameter's shape and its
    Adam moments', after each validation."""

    def __init__(self):
        self.params: dict = {}
        self.moments: dict = {}

    def on_validation_end(self, trainer, metrics) -> None:
        net, opt = trainer._model.net, trainer._optimizer
        self.params = {n: tuple(p.shape) for n, p in net.named_parameters()}
        self.moments = {n: tuple(opt.state[p]["exp_avg"].shape)
                        for n, p in net.named_parameters() if p in opt.state}


def vqvae_fit(inputs: dict, out: Path, name: str, batch: int, epochs: int = 1,
              ckpt_path=None, ckpt_dir: Path | None = None, **kw) -> dict:
    """``epochs`` epochs of STEPS steps, masking off, a recorder and the
    layouts recorded, optionally a checkpoint callback."""
    task = vqvae_task(inputs["init"], out / name)
    recorder, layouts = Recorder(), Layouts()
    callbacks = [layouts] + ([ModelCheckpoint(dirpath=str(ckpt_dir))] if ckpt_dir else [])
    trainer = Trainer(max_epochs=epochs, accelerator="cpu", enable_progress_bar=False,
                      log_every_n_steps=1, seed=0, logger=[recorder], callbacks=callbacks, **kw)
    dm = Arrays({"train": inputs["train"], "val": inputs["val"]}, batch)
    trainer.fit(task, dm, ckpt_path=ckpt_path)
    return dict(steps=recorder.metrics, callback_metrics=dict(trainer.callback_metrics),
                state=task.net.state_dict(), params=layouts.params, moments=layouts.moments,
                global_step=trainer.global_step, trainer=trainer, task=task)


def slim(fit: dict) -> dict:
    return {k: v for k, v in fit.items() if k not in ("trainer", "task")}


def predict(inputs: dict, out: Path, **kw) -> list[torch.Tensor]:
    dm = Arrays({"test": inputs["test"]}, B)
    return Trainer(accelerator="cpu", enable_progress_bar=False, **kw).predict(
        vqvae_task(inputs["init"], out / "predict"), dm)


def checkpoints(inputs: dict, out: Path, rank: int) -> dict:
    """A (2, 2) fsdp + tp fit of one epoch writes last.ckpt (rank 0); the
    gathered state beside it; resumed for a second epoch under (4, 1) zero1
    and under (2, 2) fsdp + tp; an uninterrupted (2, 2) fsdp + tp fit of two
    epochs; the JAX ``.ckpt`` loaded under (2, 2) fsdp + tp and written back
    as the port's file."""
    shared = out / "ckpt"
    sharded = dict(model_parallel=2, fsdp=True)
    first = vqvae_fit(inputs, out, f"first{rank}", 2 * B, ckpt_dir=shared, **sharded)
    first["trainer"].save_checkpoint(out / "gathered.ckpt")   # every rank gathers; rank 0 writes
    last = shared / "last.ckpt"
    zero1 = vqvae_fit(inputs, out, f"zero1_{rank}", B, epochs=2, ckpt_path=str(last), zero1=True)
    again = vqvae_fit(inputs, out, f"again{rank}", 2 * B, epochs=2, ckpt_path=str(last), **sharded)
    whole = vqvae_fit(inputs, out, f"whole{rank}", 2 * B, epochs=2, **sharded)

    task = vqvae_task(inputs["init"], out / f"jax{rank}")
    trainer = Trainer(max_epochs=1, accelerator="cpu", enable_progress_bar=False, seed=0,
                      **sharded)
    trainer.fit(task, Arrays({"train": inputs["train"], "val": inputs["val"]}, 2 * B),
                ckpt_path=inputs["jax_ckpt"])   # epoch 1 of 1: restored, nothing trained
    trainer.save_checkpoint(out / "from_jax.ckpt")
    return dict(first=slim(first), zero1=slim(zero1), again=slim(again), whole=slim(whole),
                from_jax=dict(state=task.net.state_dict(), epoch=trainer.current_epoch))


def moe_aux(inputs: dict, rank: int, world: int, mp: int) -> dict:
    """The MoE's aux loss on this data index's rows, its experts on this
    model index, and the gradients after the mean over the data group."""
    from msla_tpu_torch.nn.moe import MoEFFN
    from msla_tpu_torch.parallel.mesh import data_axis, make_grid, mean_gradients, on_grid
    from msla_tpu_torch.parallel.sharding import ShardedState

    params = inputs["moe_params"]
    m, e = params["router"].shape
    holder = nn.Module()
    holder.moe = MoEFFN(m, params["w1"].shape[-1], e, num_selected=2,
                        generator=torch.Generator().manual_seed(0), device="cpu")
    holder.moe.load_state_dict(params)
    grid = make_grid(mp)
    state = ShardedState(holder, grid)
    x = inputs["moe_x"]
    rows = x.shape[0] // grid.dp
    with on_grid(grid):
        state.shard()
        with state.use():
            with data_axis():
                y, aux = holder.moe(x[grid.data_index * rows:(grid.data_index + 1) * rows])
            (aux + y.square().mean()).backward()
            mean_gradients(holder.parameters())
            grads = {n: p.grad.clone() for n, p in holder.moe.named_parameters()}
    return dict(aux=aux.detach(), y=y.detach(), grads=grads, data_index=grid.data_index,
                model_index=grid.model_index)


def transformer_fit(inputs: dict, out: Path, name: str, batch: int, experts: int,
                    **kw) -> dict:
    """STEPS steps of the transformer over the frozen VQ-VAE at its init
    (the teacher), at dropout 0; the layouts recorded."""
    from msla_tpu_torch.data.transform import Quantize
    from msla_tpu_torch.models.transformer import TransformerTask

    teacher = vqvae_task(inputs["init"], out / name)
    task = TransformerTask(**TRANSFORMER, checkpoint_dir=str(out / name),
                           latent_channels=CFG["embedding_dim"], moe_experts=experts,
                           device="cpu")
    if experts:   # the JAX Trainer's init; the dense one the port's own (seed 0)
        task.net.load_state_dict(inputs["moe_init"])
    layouts = Layouts()
    trainer = Trainer(max_epochs=1, accelerator="cpu", enable_progress_bar=False,
                      log_every_n_steps=0, seed=0, callbacks=[layouts], **kw)
    dm = Arrays({"train": inputs["t_train"], "val": inputs["t_val"]}, batch,
                sample_rate=TRANSFORMER["sample_rate"], duration=TRANSFORMER["frame_length"],
                quantizer=Quantize(teacher), quantized_latents=True)
    trainer.fit(task, dm)
    return dict(callback_metrics=dict(trainer.callback_metrics), state=task.net.state_dict(),
                params=layouts.params, moments=layouts.moments)


def late(inputs: dict, root: Path, timeout_s: float = 300.0) -> dict:
    """``inputs`` and ``<root>/late.pt`` once it is there (written whole,
    then renamed)."""
    deadline = time.monotonic() + timeout_s
    while not (root / "late.pt").exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{root / 'late.pt'} did not come")
        time.sleep(0.05)
    return {**inputs, **torch.load(root / "late.pt")}


def model_launch(inputs: dict, root: Path, out: Path, rank: int, world: int) -> dict:
    result = dict(
        dp4=slim(vqvae_fit(inputs, out, f"dp4_{rank}", B)),
        zero1=slim(vqvae_fit(inputs, out, f"zero1_{rank}", B, zero1=True)),
        fsdp=slim(vqvae_fit(inputs, out, f"fsdp_{rank}", B, fsdp=True)),
        mp=slim(vqvae_fit(inputs, out, f"mp_{rank}", 2 * B, model_parallel=2)),
        mp_fsdp=slim(vqvae_fit(inputs, out, f"mpf_{rank}", 2 * B, model_parallel=2, fsdp=True)),
        predict=predict(inputs, out, model_parallel=2),
        ckpt=checkpoints(inputs, out, rank))
    print("TIMING VQ cases done", time.time(), flush=True)
    inputs = late(inputs, root)
    print("TIMING late", time.time(), flush=True)
    return dict(result, moe_aux=moe_aux(inputs, rank, world, 2),
                moe=transformer_fit(inputs, out, f"moe{rank}", 2 * B, EXPERTS, model_parallel=2),
                dense=transformer_fit(inputs, out, f"dense{rank}", 2 * B, 0, model_parallel=2))


def data_launch(inputs: dict, root: Path, out: Path, rank: int, world: int) -> dict:
    result = dict(dp2=slim(vqvae_fit(inputs, out, f"dp2_{rank}", 2 * B)))
    inputs = late(inputs, root)
    return dict(result, moe=transformer_fit(inputs, out, f"moe{rank}", 2 * B, EXPERTS),
                dense=transformer_fit(inputs, out, f"dense{rank}", 2 * B, 0))


def main(out: Path, launch: str) -> None:
    from msla_tpu_torch.parallel.distributed import setup_distributed, teardown_distributed
    from msla_tpu_torch.parallel.mesh import process_info

    torch.set_num_threads(1)
    assert setup_distributed(), "the launcher's environment was not picked up"
    rank, world = process_info()
    inputs = torch.load(out / "inputs.pt")
    for split in ("train", "val", "test", "t_train", "t_val"):
        inputs[split] = inputs[split].numpy()
    runs = model_launch if launch == "model" else data_launch
    result = dict(rank=rank, world=world, **runs(inputs, out, out / launch, rank, world))
    torch.save(result, out / f"{launch}{rank}.pt")
    teardown_distributed()
    print(f"rank {rank} of {world} done", flush=True)


if __name__ == "__main__":
    main(Path(sys.argv[1]), sys.argv[2])
