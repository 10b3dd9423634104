"""The ranks of the pipeline tests, and what they share with the tests.

    python -m msla_tpu_torch.parallel.launch --nproc 4 --platform cpu -- \
        tests/_torch_pp.py <dir>

Each rank joins the gloo group, reads ``<dir>/inputs.pt`` (written by
``tests/test_torch_pipeline.py``: the data), runs every case below in one
order, each once the JAX init it needs is in ``<dir>`` (``net.pt``,
``bert.pt``, ``fit.pt``, ``ab.pt``, written whole and renamed while the
ranks run), and writes what it saw to ``<dir>/rank<r>.pt``. The
(dp, pp) grids are the world's 4 ranks as (2, 2) or (1, 4); a data index
holds the global batch's rows d, d + dp, … (the loaders' interleave), and
the (4, 1) runs are data parallelism alone. No JAX here: the tests compare
these files with the JAX package in their own process.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch import nn

from _torch_dp import Recorder
from _torch_mp import Arrays

TOY = dict(layers=4, d=8, batch=16)
TOY_RUNS = [(2, 2), (2, 4), (4, 2), (4, 4)]          # (pp, n_micro); dp = 4 // pp
NET = dict(input_dim=32, output_dim=128, hidden_dim=16, num_layers=4, num_heads=2,
           dropout=0.0)                                 # tests/test_pipeline.py:68-72
NET_RUNS = [(2, 2), (4, 4)]
BERT = dict(vocab_size=64, hidden_size=16, num_hidden_layers=4, num_attention_heads=2,
            intermediate_size=32, max_position_embeddings=64)   # tests/test_pipeline.py:146-148
FIT = dict(sample_rate=64, frame_length=2, learning_rate=1e-3, num_layers=2, num_heads=2,
           hidden_dim=16, dropout=0.0)                  # tests/test_parallel.py:459-494
FIT_BATCH, FIT_EPOCHS = 8, 2                            # the global batch
AB = dict(learning_rate=2e-4, sample_rate=1024, frame_length=2, num_embedding=16)
AB_BERT = dict(vocab_size=64, hidden_size=16, num_hidden_layers=4, num_attention_heads=2,
               intermediate_size=32, max_position_embeddings=512)
AB_BATCH, AB_STEPS = 8, 3


def toy_apply(layer, h, a, g):
    return torch.tanh(h @ layer.w + layer.b)


def toy_layers(params: dict) -> nn.ModuleList:
    layers = nn.ModuleList()
    for i in range(len(params)):
        m = nn.Module()
        m.w = nn.Parameter(params[f"layer{i}"]["w"].clone())
        m.b = nn.Parameter(params[f"layer{i}"]["b"].clone())
        layers.append(m)
    return layers


def fake_ids(raw):
    """Audio-BERT's code ids from (B, 4, T) stems, a stand-in teacher: W = T/4."""
    return (np.floor(np.abs(np.asarray(raw)[:, 0, ::4]) * 5) % AB["num_embedding"]
            ).astype(np.int64)


class Latents(Arrays):
    """tests/test_parallel.py's transformer datamodule: the stems' first two
    channels as (B, 8, 32) latents."""

    def on_after_batch_transfer(self, batch):
        return batch[:, :2, :].reshape(batch.shape[0], 8, 32), batch


class CodeIds(Arrays):
    def on_after_batch_transfer(self, batch):
        return torch.from_numpy(fake_ids(batch)), batch


class RecordingAdam(torch.optim.Adam):
    """Adam that keeps each step's gradients, by parameter name."""

    def __init__(self, named, **kw):
        named = list(named)
        super().__init__([p for _, p in named], **kw)
        self.names = {id(p): n for n, p in named}
        self.grads: list[dict] = []

    def step(self, closure=None):
        self.grads.append({self.names[id(p)]: p.grad.clone() for g in self.param_groups
                           for p in g["params"] if p.grad is not None})
        return super().step(closure)


def wait_for(root: Path, name: str, timeout_s: float = 300.0) -> dict:
    """``<root>/<name>.pt`` once it is there (written whole, then renamed)."""
    deadline = time.monotonic() + timeout_s
    while not (root / f"{name}.pt").exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{root / name}.pt did not come")
        time.sleep(0.05)
    return torch.load(root / f"{name}.pt", weights_only=False)


def rows(t, grid):
    return t[grid.data_index::grid.dp]


def toy(inputs: dict) -> dict:
    from msla_tpu_torch.parallel.mesh import make_grid
    from msla_tpu_torch.parallel.pipeline import mean_gradients, spmd_pipeline

    out = {}
    for pp, n_micro in TOY_RUNS:
        grid = make_grid(pp)
        layers = toy_layers(inputs["toy_params"])
        y = spmd_pipeline(toy_apply, layers, rows(inputs["toy_x"], grid), grid, n_micro=n_micro)
        y.square().mean().backward()
        mean_gradients(layers.parameters(), layers, grid)
        out[(pp, n_micro)] = dict(y=y.detach(), grads={
            f"layer{i}.{k}": getattr(m, k).grad for i, m in enumerate(layers) for k in "wb"})
    return out


def transformer_net(init: dict, **kw):
    from msla_tpu_torch.nn.transformer_net import TransformerQuantizerNet

    net = TransformerQuantizerNet(**{**NET, **kw}, latent_channels=8, device="cpu")
    net.load_state_dict(init)
    return net


def transformer(inputs: dict) -> dict:
    from msla_tpu_torch.parallel.mesh import data_axis, make_grid, on_grid
    from msla_tpu_torch.parallel.pipeline import mean_gradients, pipelined_transformer_apply

    out = {}
    for pp, n_micro in NET_RUNS:
        grid = make_grid(pp)
        net = transformer_net(inputs["net_init"])
        with on_grid(grid), data_axis():
            y = pipelined_transformer_apply(net, rows(inputs["net_q"], grid), grid,
                                            n_micro=n_micro)
            loss = (y - rows(inputs["net_target"], grid)).square().mean()
            loss.backward()
            mean_gradients(net.parameters(), [getattr(net, f"layer{i}") for i in range(4)], grid)
        out[(pp, n_micro)] = dict(y=y.detach(), loss=loss.detach(),
                                  grads={n: p.grad for n, p in net.named_parameters()})
    return out


def bert(inputs: dict) -> dict:
    from msla_tpu_torch.nn.bert import BertConfig, BertForMaskedLM
    from msla_tpu_torch.parallel.mesh import make_grid
    from msla_tpu_torch.parallel.pipeline import pipelined_bert_apply

    model = BertForMaskedLM(BertConfig(**BERT), device="cpu")
    model.load_state_dict(inputs["bert_init"])
    out = {}
    with torch.no_grad():
        for pp, n_micro in NET_RUNS:
            grid = make_grid(pp)
            ids, mask = rows(inputs["bert_ids"], grid), rows(inputs["bert_mask"], grid)
            out[(pp, n_micro)] = dict(
                logits=pipelined_bert_apply(model, ids, grid, n_micro=n_micro,
                                            attention_mask=mask),
                hidden=pipelined_bert_apply(model, ids, grid, n_micro=n_micro,
                                            attention_mask=mask, return_mlm_hidden=True))
    return out


def audio_bert_task(inputs: dict, out: Path, **kw):
    from msla_tpu_torch.models.bert import AudioBertTask
    from msla_tpu_torch.nn.bert import BertConfig

    task = AudioBertTask(**AB, checkpoint_dir=str(out / "ab"), codebook=inputs["codebook_csv"],
                         mask_prob=0.0, device="cpu", config=BertConfig(**AB_BERT), **kw)
    task.net.load_state_dict(inputs["ab_init"])
    return task


def audio_bert_loss(inputs: dict, out: Path) -> dict:
    from msla_tpu_torch.parallel.mesh import data_axis, make_grid, on_grid

    grid = make_grid(2)
    task = audio_bert_task(inputs, out)
    raw = torch.from_numpy(inputs["ab_train"][:AB_BATCH])
    batch = (rows(torch.from_numpy(fake_ids(raw)), grid), rows(raw, grid))
    with on_grid(grid), data_axis():
        loss, _ = task.pipeline_loss_fn(batch, torch.Generator().manual_seed(0), grid, 2)
        plain, _ = task.loss_fn(batch, torch.Generator().manual_seed(0))
    return dict(loss=loss.detach(), plain=plain.detach())


def dropout(inputs: dict) -> dict:
    """The transformer's pipelined forward at dropout 0.5, the same
    generator seed at pp = 1, 2 and 4 (n_micro 4), on the whole batch."""
    from msla_tpu_torch.parallel.mesh import make_grid
    from msla_tpu_torch.parallel.pipeline import pipelined_transformer_apply

    net = transformer_net(inputs["net_init"], dropout=0.5)
    q = inputs["net_q"]
    with torch.no_grad():
        live = {pp: pipelined_transformer_apply(net, q, make_grid(pp), n_micro=4,
                                                generator=torch.Generator().manual_seed(1))
                for pp in (1, 2, 4)}
        again = pipelined_transformer_apply(net, q, make_grid(2), n_micro=4,
                                            generator=torch.Generator().manual_seed(1))
        other = pipelined_transformer_apply(net, q, make_grid(2), n_micro=4,
                                            generator=torch.Generator().manual_seed(2))
        det = pipelined_transformer_apply(net, q, make_grid(2), n_micro=4)
    return dict(live=live, again=again, other=other, det=det)


def refusals(inputs: dict, out: Path) -> dict:
    """JAX's ValueErrors under the pipeline, as strings."""
    from _torch_dp import CFG
    from msla_tpu_torch.models.transformer import TransformerTask
    from msla_tpu_torch.models.vqvae import VQVAETask
    from msla_tpu_torch.parallel.mesh import make_grid
    from msla_tpu_torch.parallel.pipeline import pipelined_transformer_apply
    from msla_tpu_torch.train.trainer import Trainer

    def caught(fn):
        try:
            fn()
        except ValueError as err:
            return str(err)
        return None

    grid = make_grid(2)
    q = inputs["net_q"]
    three = transformer_net({k: v for k, v in inputs["net_init"].items()
                             if not k.startswith("layer3.")}, num_layers=3)
    four = transformer_net(inputs["net_init"])
    vq = VQVAETask(**CFG, checkpoint_dir=str(out / "vq"), codebook_file=str(out / "vq.csv"),
                   device="cpu")
    moe = TransformerTask(**FIT, checkpoint_dir=str(out / "moe"), latent_channels=8,
                          moe_experts=2, device="cpu")
    trainer = Trainer(max_epochs=1, accelerator="cpu", enable_progress_bar=False,
                      pipeline_parallel=2)
    vq_splits = {"train": np.zeros((4, 4, 1000), np.float32)}
    vq_splits["val"] = vq_splits["train"]
    return dict(
        layers=caught(lambda: pipelined_transformer_apply(three, q[:4], grid, n_micro=2)),
        n_micro=caught(lambda: pipelined_transformer_apply(four, q[:4], grid, n_micro=3)),
        microbatch=caught(lambda: pipelined_transformer_apply(four, q[:4], grid, n_micro=8)),
        vqvae=caught(lambda: trainer.fit(vq, Arrays(vq_splits, 2, sample_rate=CFG["sample_rate"]))),
        moe=caught(lambda: moe.pipeline_loss_fn((q[:4], torch.zeros(4, 4, 128)), None, grid, 2)))


def transformer_fit(inputs: dict, out: Path, name: str, batch: int, epochs: int = FIT_EPOCHS,
                    record: bool = False, ckpt_dir: Path | None = None, ckpt_path=None,
                    task_kw: dict | None = None, **kw) -> dict:
    from msla_tpu_torch.models.transformer import TransformerTask
    from msla_tpu_torch.train.callbacks import ModelCheckpoint
    from msla_tpu_torch.train.trainer import Trainer

    task = TransformerTask(**{**FIT, **(task_kw or {})}, checkpoint_dir=str(out / name),
                           latent_channels=8, device="cpu")
    task.net.load_state_dict(inputs["fit_init"])
    if record:
        task.configure_optimizer = lambda: RecordingAdam(
            task.net.named_parameters(), lr=FIT["learning_rate"], betas=(0.9, 0.999), eps=1e-8)
    recorder = Recorder()
    callbacks = [ModelCheckpoint(dirpath=str(ckpt_dir))] if ckpt_dir else []
    trainer = Trainer(max_epochs=epochs, accelerator="cpu", enable_progress_bar=False,
                      log_every_n_steps=1, seed=0, logger=[recorder], callbacks=callbacks, **kw)
    dm = Latents({"train": inputs["fit_train"], "val": inputs["fit_train"]}, batch,
                 sample_rate=FIT["sample_rate"], duration=FIT["frame_length"])
    trainer.fit(task, dm, ckpt_path=ckpt_path)
    result = dict(steps=recorder.metrics, callback_metrics=dict(trainer.callback_metrics),
                  state=task.net.state_dict(), global_step=trainer.global_step)
    if record:
        result["grads"] = trainer._optimizer.grads
    return result


def audio_bert_fit(inputs: dict, out: Path, name: str, batch: int, **kw) -> dict:
    from msla_tpu_torch.train.trainer import Trainer

    task = audio_bert_task(inputs, out / name)
    recorder = Recorder()
    trainer = Trainer(max_epochs=1, accelerator="cpu", enable_progress_bar=False,
                      log_every_n_steps=1, seed=0, logger=[recorder], **kw)
    dm = CodeIds({"train": inputs["ab_train"], "val": inputs["ab_train"][:AB_BATCH]}, batch,
                 sample_rate=AB["sample_rate"], duration=AB["frame_length"])
    trainer.fit(task, dm)
    return dict(steps=recorder.metrics, callback_metrics=dict(trainer.callback_metrics),
                state=task.net.state_dict())


def transformer_fits(inputs: dict, out: Path, rank: int) -> dict:
    pp = dict(pipeline_parallel=2, pipeline_microbatches=2)
    half = FIT_BATCH // 2
    ckpt = out / "ckpt"
    result = dict(
        pp=transformer_fit(inputs, out, f"pp{rank}", half, **pp),
        dp=transformer_fit(inputs, out, f"dp{rank}", FIT_BATCH // 4),
        zero1=transformer_fit(inputs, out, f"zero1_{rank}", half, zero1=True, **pp),
        first=transformer_fit(inputs, out, f"first{rank}", half, epochs=1, ckpt_dir=ckpt, **pp))
    result["resumed"] = transformer_fit(inputs, out, f"resumed{rank}", half,
                                        ckpt_path=str(ckpt / "last.ckpt"), **pp)
    live = dict(task_kw=dict(dropout=0.1), epochs=1, record=True, **pp)
    result["remat"] = transformer_fit(inputs, out, f"remat{rank}", half, remat=True, **live)
    result["no_remat"] = transformer_fit(inputs, out, f"noremat{rank}", half, **live)
    standard = dict(task_kw=dict(positional_mode="standard"), epochs=1, record=True, **pp)
    result["accumulate"] = transformer_fit(inputs, out, f"acc{rank}", half // 2,
                                           accumulate_grad_batches=2, **standard)
    result["twice"] = transformer_fit(inputs, out, f"twice{rank}", half, **standard)
    return result


def audio_bert_fits(inputs: dict, out: Path, rank: int) -> dict:
    return dict(ab_pp=audio_bert_fit(inputs, out, f"abpp{rank}", AB_BATCH // 2,
                                     pipeline_parallel=2),
                ab_dp=audio_bert_fit(inputs, out, f"abdp{rank}", AB_BATCH // 4))


def main(out: Path) -> None:
    from msla_tpu_torch.parallel.distributed import setup_distributed, teardown_distributed
    from msla_tpu_torch.parallel.mesh import process_info

    torch.set_num_threads(1)
    assert setup_distributed(), "the launcher's environment was not picked up"
    rank, world = process_info()
    inputs = torch.load(out / "inputs.pt", weights_only=False)
    result = dict(rank=rank, world=world, toy=toy(inputs))
    inputs.update(wait_for(out, "net"))
    result.update(transformer=transformer(inputs), dropout=dropout(inputs),
                  refusals=refusals(inputs, out))
    inputs.update(wait_for(out, "bert"))
    result["bert"] = bert(inputs)
    inputs.update(wait_for(out, "fit"))
    result["fits"] = transformer_fits(inputs, out, rank)
    inputs.update(wait_for(out, "ab"))
    result["audio_bert"] = audio_bert_loss(inputs, out)
    result["fits"].update(audio_bert_fits(inputs, out, rank))
    torch.save(result, out / f"rank{rank}.pt")
    teardown_distributed()
    print(f"rank {rank} of {world} done", flush=True)


if __name__ == "__main__":
    main(Path(sys.argv[1]))
