"""The ranks of the data-parallel tests, and what they share with the tests.

    python -m msla_tpu_torch.parallel.launch --nproc 2 --platform cpu -- \
        tests/_torch_dp.py <dir>

Each rank joins the gloo group, reads ``<dir>/inputs.pt`` (written by
``tests/test_torch_parallel.py``), runs every case below on its share of the
global batch and writes what it saw to ``<dir>/rank<r>.pt``. No JAX here: the
tests compare these files with the JAX package in their own process.
"""
from __future__ import annotations

import sys
import types
from pathlib import Path

import numpy as np
import torch

from msla_tpu_torch.data.datamodule import SlakhDataModule
from msla_tpu_torch.train.loggers import Logger

CFG = dict(num_hidden=16, num_residual_layer=2, num_residual_hidden=8, num_embedding=16,
           embedding_dim=8, commitment_cost=0.25, learning_rate=1e-4, sample_rate=1000)
B = 2                        # a rank's batch; the global batch is 2B
T, T_MASKED = 800, 4000      # frames of the unmasked and the masked fits
PREDICT_BATCH = 2            # a rank's predict batch: 9 frames end in a ragged one


class ArrayDataModule(SlakhDataModule):
    """The port's datamodule over in-memory (n, 4, T) splits: its loaders are
    the real ones, so each rank reads its interleave (``process_info``)."""

    def __init__(self, splits: dict, batch_size: int, masking: bool = False,
                 shuffle: bool = True):
        super().__init__(train_dir="train", val_dir="val", test_dir="test",
                         target_sample_rate=CFG["sample_rate"], target_sample_duration=1,
                         max_duration=120, maximum_dataset_size=100, batch_size=batch_size,
                         num_workers=0, masking=masking)
        self.splits, self.shuffle = splits, shuffle

    def create_dataset(self, path: str, masking: bool = False):
        return self.splits[path]

    def train_dataloader(self):
        return self._loader(self.splits["train"], batch_size=self.batch_size,
                            shuffle=self.shuffle, drop_last=True)

    def predict_dataloader(self):
        return self._loader(self.splits["test"], batch_size=PREDICT_BATCH, shuffle=False,
                            drop_last=False)


class Recorder(Logger):
    """Keeps what the Trainer logs, in memory."""

    def __init__(self):
        self.metrics: list[tuple[int, dict]] = []
        self.hparams = 0
        self.finalized = 0

    def log_metrics(self, metrics, step):
        self.metrics.append((step, dict(metrics)))

    def log_hyperparams(self, params):
        self.hparams += 1

    def finalize(self, status="success"):
        self.finalized += 1


def vqvae_task(init: dict, out: Path):
    from msla_tpu_torch.models.vqvae import VQVAETask

    task = VQVAETask(**CFG, checkpoint_dir=str(out / "demo"),
                     codebook_file=str(out / "codebook.csv"), device="cpu")
    task.net.load_state_dict(init)
    return task


def _files(root: Path) -> list[str]:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def fit_with_files(inputs: dict, out: Path, rank: int) -> dict:
    """3 steps and a validation, masking off, with a checkpoint callback, a
    CSV logger and a recorder, in a directory of the rank's own."""
    from msla_tpu_torch.train.callbacks import ModelCheckpoint
    from msla_tpu_torch.train.loggers import CSVLogger
    from msla_tpu_torch.train.trainer import Trainer

    mine = out / f"files{rank}"
    task = vqvae_task(inputs["init"], mine)
    recorder = Recorder()
    trainer = Trainer(max_epochs=1, accelerator="cpu", enable_progress_bar=False,
                      log_every_n_steps=1, seed=0,
                      logger=[recorder, CSVLogger(str(mine / "logs"))],
                      callbacks=[ModelCheckpoint(dirpath=str(mine / "ckpt"), filename="best")])
    dm = ArrayDataModule({"train": inputs["train"], "val": inputs["val"],
                          "test": inputs["test"]}, B, shuffle=False)
    trainer.fit(task, dm)
    return dict(steps=recorder.metrics, hparams=recorder.hparams, finalized=recorder.finalized,
                callback_metrics=dict(trainer.callback_metrics), global_step=trainer.global_step,
                state=task.net.state_dict(), files=_files(mine))


def fit_masked(inputs: dict, out: Path) -> dict:
    """3 steps with masking on and the shuffled interleave."""
    from msla_tpu_torch.train.trainer import Trainer

    task = vqvae_task(inputs["init"], out / "masked")
    trainer = Trainer(max_epochs=1, accelerator="cpu", enable_progress_bar=False,
                      log_every_n_steps=0, seed=0)
    dm = ArrayDataModule({"train": inputs["train_masked"], "val": inputs["val_masked"]}, B,
                         masking=True)
    trainer.fit(task, dm)
    return dict(callback_metrics=dict(trainer.callback_metrics), state=task.net.state_dict())


def early_stop_and_resume(inputs: dict, out: Path) -> dict:
    """EarlyStopping on a patience of 1 and a min_delta no change meets, with
    one checkpoint directory for both ranks; then a fit from "last"."""
    from msla_tpu_torch.train.callbacks import EarlyStopping, ModelCheckpoint
    from msla_tpu_torch.train.trainer import Trainer

    shared = out / "shared"
    dm = ArrayDataModule({"train": inputs["train"], "val": inputs["val"]}, B)

    def trainer(epochs):
        return Trainer(max_epochs=epochs, limit_train_batches=1, accelerator="cpu",
                       enable_progress_bar=False, seed=0,
                       callbacks=[EarlyStopping(patience=1, min_delta=1e3),
                                  ModelCheckpoint(dirpath=str(shared / "ckpt"))])

    first = trainer(5)
    first.fit(vqvae_task(inputs["init"], shared), dm)
    again = trainer(3)
    task = vqvae_task(inputs["init"], shared)
    again.fit(task, dm, ckpt_path="last")
    return dict(stopped_at=first.current_epoch, resumed_to=again.current_epoch,
                resumed_step=again.global_step, state=task.net.state_dict())


def predict(inputs: dict, out: Path) -> list[torch.Tensor]:
    from msla_tpu_torch.train.trainer import Trainer

    dm = ArrayDataModule({"test": inputs["test"]}, B)
    return Trainer(accelerator="cpu", enable_progress_bar=False).predict(
        vqvae_task(inputs["init"], out / "predict"), dm)


def bert_code_ids(inputs: dict, rank: int) -> dict:
    """``AudioBertTask._code_ids`` on this rank's vocab ids, inside and outside
    a data-parallel step."""
    from msla_tpu_torch.models.bert import AudioBertTask
    from msla_tpu_torch.parallel.mesh import data_axis

    task = types.SimpleNamespace(net=types.SimpleNamespace(codebook=torch.zeros(16, 8)))
    ids = inputs["bert_ids"][rank]
    with data_axis():
        global_max = AudioBertTask._code_ids(task, ids)
    return dict(sharded=global_max, local=AudioBertTask._code_ids(task, ids))


def moe_aux(inputs: dict, rank: int, world: int) -> dict:
    """The MoE's aux loss on this rank's rows and the router's gradient after
    the Trainer's mean over the ranks."""
    from msla_tpu_torch.nn.moe import MoEFFN
    from msla_tpu_torch.parallel.mesh import data_axis, mean_gradients

    params = inputs["moe_params"]
    m, e = params["router"].shape
    moe = MoEFFN(m, params["w1"].shape[-1], e, num_selected=2,
                 generator=torch.Generator().manual_seed(0), device="cpu")
    moe.load_state_dict(params)
    x = inputs["moe_x"]
    rows = x.shape[0] // world
    with data_axis():
        _, aux = moe(x[rank * rows:(rank + 1) * rows])
    aux.backward()
    mean_gradients(moe.parameters())
    return dict(aux=aux.detach(), router_grad=moe.router.grad,
                others=[n for n, p in moe.named_parameters() if p.grad is not None])


def main(out: Path) -> None:
    from msla_tpu_torch.parallel.distributed import setup_distributed, teardown_distributed
    from msla_tpu_torch.parallel.mesh import process_info

    torch.set_num_threads(2)
    assert setup_distributed(), "the launcher's environment was not picked up"
    rank, world = process_info()
    inputs = torch.load(out / "inputs.pt")
    for split in ("train", "val", "test", "train_masked", "val_masked"):
        inputs[split] = inputs[split].numpy()
    result = dict(rank=rank, world=world, backend=torch.distributed.get_backend(),
                  fit=fit_with_files(inputs, out, rank), masked=fit_masked(inputs, out),
                  early=early_stop_and_resume(inputs, out), predict=predict(inputs, out),
                  bert=bert_code_ids(inputs, rank), moe=moe_aux(inputs, rank, world))
    torch.save(result, out / f"rank{rank}.pt")
    teardown_distributed()
    print(f"rank {rank} of {world} done", flush=True)


if __name__ == "__main__":
    main(Path(sys.argv[1]))
