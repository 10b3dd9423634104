"""Data parallelism on the CPU: 2 gloo ranks of the port at batch B against the
JAX package at the global batch 2B, in this process, on the same weights.

The ranks run once, through ``python -m msla_tpu_torch.parallel.launch
--nproc 2 --platform cpu`` (``tests/_torch_dp.py``), and write what they saw;
the cases below read it. The global batch is the ranks' batches side by side:
the JAX loader's batch i at 2B holds the rows of the ranks' batch i (rank r's
rows are the loader's r, r + 2, …). Unshuffled where JAX is compared: the
JAX Trainer draws one permutation to build its state before its first epoch.

* VQ-VAE ``fit``, 3 steps, masking off: each step's loss and perplexity (the
  perplexity from the global batch's code counts) at rtol 1e-5, the epoch
  metrics at 1e-3, the parameters' moves within 0.2·lr of JAX's where the
  first gradient is clear of 0 (ROADMAP.md §3's table), as
  ``tests/test_torch_train.py`` holds one process;
* the 2 ranks against the port's one process at 2B, masking off and on (the
  masks drawn for the global batch, each rank taking its rows'): parameters
  at rtol 1e-5;
* the ranks bit-equal to each other, with the same ``callback_metrics``;
* rank 0 alone writes checkpoints, the codebook CSV, logs and the demo WAVs;
* EarlyStopping stops both ranks at one epoch, and both resume from the
  ``last.ckpt`` rank 0 wrote;
* ``predict`` in loader order, the ragged tail and the wrapped duplicate too;
* Audio-BERT's code ids divide by the global batch's largest id, which only
  rank 1 holds; the MoE's aux loss and its router gradient against JAX at 2B.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dp import B, CFG, PREDICT_BATCH, T, T_MASKED, ArrayDataModule, vqvae_task
from msla_tpu.data.datamodule import SlakhDataModule as JaxSlakhDataModule
from msla_tpu.models.vqvae import VQVAETask as JaxVQVAETask
from msla_tpu.nn.moe import MoEFFN as JaxMoEFFN
from msla_tpu.train.loggers import Logger as JaxLogger
from msla_tpu.train.trainer import Trainer as JaxTrainer
from msla_tpu_torch.train.trainer import Trainer
from msla_tpu_torch.utils.jax_compat import vqvae_state_dict_from_jax

REPO = Path(__file__).resolve().parent.parent
WORLD = 2
STEPS = 3
MOE = dict(m=16, f=32, e=4, rows=4, s=8)
BERT_IDS = [torch.tensor([[3, 7, 2, 9], [1, 0, 8, 4]]),
            torch.tensor([[11, 5, 0, 4], [6, 2, 10, 3]])]   # the largest, 11, on rank 1


def _stems(n: int, t: int, seed: int) -> np.ndarray:
    """A tone a stem at a random pitch and loudness over a random offset: loud
    enough that the initial codebook takes more than one code, so that a
    rank's own perplexity is not the global batch's and frames decode apart."""
    rng = np.random.default_rng(seed)
    time = np.arange(t) / CFG["sample_rate"]
    f0, amp = rng.uniform(20, 400, (n, 4, 1)), rng.uniform(0.1, 20, (n, 4, 1))
    return (amp * np.sin(2 * np.pi * f0 * time) + rng.uniform(-3, 3, (n, 4, 1))
            ).astype(np.float32)


SPLITS = dict(train=_stems(STEPS * WORLD * B, T, 0), val=_stems(WORLD * B, T, 1),
              test=_stems(9, T, 2))
MASKED = dict(train=_stems(STEPS * WORLD * B, T_MASKED, 3), val=_stems(WORLD * B, T_MASKED, 4))


class JaxArrays(JaxSlakhDataModule):
    def __init__(self, splits, batch_size):
        super().__init__(train_dir="train", val_dir="val", test_dir="test",
                         target_sample_rate=CFG["sample_rate"], target_sample_duration=1,
                         max_duration=120, maximum_dataset_size=100, batch_size=batch_size,
                         num_workers=0)
        self.splits = splits

    def create_dataset(self, path, masking=False):
        return self.splits[path]

    def train_dataloader(self):
        return self._loader(self.splits["train"], batch_size=self.batch_size, shuffle=False,
                            drop_last=True)


class JaxRecorder(JaxLogger):
    def __init__(self):
        self.metrics = []

    def log_metrics(self, metrics, step):
        self.metrics.append((step, dict(metrics)))


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX task and its init (seed 0), the Trainer's ``fit`` at 2B with a
    recorder, and the first step's gradients."""
    tmp = tmp_path_factory.mktemp("jax_dp")
    task = JaxVQVAETask(**CFG, checkpoint_dir=str(tmp), codebook_file=str(tmp / "cb.csv"))
    dm = JaxArrays(SPLITS, WORLD * B)
    batch0 = dm.on_after_batch_transfer(jnp.asarray(SPLITS["train"][:WORLD * B]))
    params = task.init_variables(jax.random.PRNGKey(0), batch0)["params"]
    recorder = JaxRecorder()
    trainer = JaxTrainer(default_root_dir=str(tmp), max_epochs=1, accelerator="cpu",
                         enable_progress_bar=False, log_every_n_steps=1, seed=0,
                         logger=[recorder])
    trainer.fit(task, dm)
    grads = jax.grad(lambda p: task.loss_fn(p, batch0, jax.random.PRNGKey(0))[0])(params)
    layers = CFG["num_residual_layer"]
    return dict(init=vqvae_state_dict_from_jax(jax.device_get(params), layers),
                final=vqvae_state_dict_from_jax(jax.device_get(trainer.state.params), layers),
                grads=vqvae_state_dict_from_jax(grads, layers), steps=recorder.metrics,
                callback_metrics=trainer.callback_metrics)


@pytest.fixture(scope="module")
def moe_side():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((MOE["rows"], MOE["s"], MOE["m"])).astype(np.float32)
    moe = JaxMoEFFN(MOE["m"], MOE["f"], MOE["e"], num_selected=2)
    params = jax.device_get(moe.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])

    def aux(router):
        _, state = moe.apply({"params": {**params, "router": router}}, jnp.asarray(x),
                             mutable=["losses"])
        return jax.tree_util.tree_leaves(state["losses"])[0]

    value, grad = jax.value_and_grad(aux)(jnp.asarray(params["router"]))
    return dict(x=x, params=params, aux=float(value), router_grad=np.asarray(grad))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_side, moe_side):
    """Both ranks' results: one launch of ``tests/_torch_dp.py``."""
    root = tmp_path_factory.mktemp("ranks")
    torch.save(dict(init=jax_side["init"],
                    **{k: torch.from_numpy(v) for k, v in SPLITS.items()},
                    **{f"{k}_masked": torch.from_numpy(v) for k, v in MASKED.items()},
                    moe_params={k: torch.from_numpy(np.array(v))
                                for k, v in moe_side["params"].items()},
                    moe_x=torch.from_numpy(moe_side["x"]), bert_ids=BERT_IDS),
               root / "inputs.pt")
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
    proc = subprocess.run(
        [sys.executable, "-m", "msla_tpu_torch.parallel.launch", "--nproc", str(WORLD),
         "--platform", "cpu", "--", str(REPO / "tests" / "_torch_dp.py"), str(root)],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-6000:] + proc.stderr[-2000:]
    return [torch.load(root / f"rank{r}.pt") for r in range(WORLD)]


@pytest.fixture(scope="module")
def one_process(jax_side, tmp_path_factory):
    """The port in this process, no group, at the global batch 2B."""
    tmp = tmp_path_factory.mktemp("one")
    out = {}
    for name, splits, masking in (("fit", SPLITS, False), ("masked", MASKED, True)):
        task = vqvae_task(jax_side["init"], tmp / name)
        dm = ArrayDataModule(dict(splits), WORLD * B, masking=masking, shuffle=masking)
        Trainer(max_epochs=1, accelerator="cpu", enable_progress_bar=False,
                log_every_n_steps=0, seed=0).fit(task, dm)
        out[name] = task.net.state_dict()
    return out


def test_the_ranks_ran_under_gloo(ranks):
    assert [(r["rank"], r["world"], r["backend"]) for r in ranks] == [(0, 2, "gloo"),
                                                                     (1, 2, "gloo")]
    assert [r["fit"]["global_step"] for r in ranks] == [STEPS, STEPS]


@pytest.mark.parametrize("key", ["train/loss", "train/perplexity"])
def test_each_step_matches_jax_at_the_global_batch(ranks, jax_side, key):
    got = [(step, m[key]) for step, m in ranks[0]["fit"]["steps"][:STEPS]]
    want = [(step, m[key]) for step, m in jax_side["steps"][:STEPS]]
    if key == "train/perplexity":   # more than one code: the global count matters
        assert min(v for _, v in want) > 1.05, want
    assert [s for s, _ in got] == [s for s, _ in want] == list(range(1, STEPS + 1))
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-5)


def test_epoch_metrics_match_jax(ranks, jax_side):
    want = jax_side["callback_metrics"]
    got = ranks[0]["fit"]["callback_metrics"]
    assert set(got) == set(want) and len(want) == 21
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-3, err_msg=k)


def test_parameter_moves_match_jax(ranks, jax_side):
    lr = CFG["learning_rate"]
    for key, value in ranks[0]["fit"]["state"].items():
        start, g = jax_side["init"][key], jax_side["grads"][key].abs()
        sure = g > 1e-3 * g.max()
        moved, want = value - start, jax_side["final"][key] - start
        assert want[sure].abs().max() > lr, key
        np.testing.assert_allclose(moved[sure].numpy(), want[sure].numpy(), rtol=0,
                                   atol=0.2 * lr, err_msg=key)


@pytest.mark.parametrize("case", ["fit", "masked", "early"])
def test_the_ranks_hold_the_same_state(ranks, case):
    a, b = ranks[0][case], ranks[1][case]
    for key in a["state"]:
        assert torch.equal(a["state"][key], b["state"][key]), key
    assert a.get("callback_metrics") == b.get("callback_metrics")


@pytest.mark.parametrize("case", ["fit", "masked"])
def test_two_ranks_match_one_process_at_twice_the_batch(ranks, one_process, case):
    for key, value in ranks[0][case]["state"].items():
        np.testing.assert_allclose(value.numpy(), one_process[case][key].numpy(), rtol=1e-5,
                                   err_msg=key)


def test_only_rank_zero_writes(ranks):
    zero, one = ranks[0]["fit"], ranks[1]["fit"]
    assert one["files"] == [] and one["steps"] == [] and one["hparams"] == 0
    assert one["finalized"] == 0
    for name in ("ckpt/last.ckpt", "ckpt/best.ckpt", "ckpt/best-v0.ckpt", "codebook.csv",
                 "logs/metrics.csv", "demo/generated_full_song.wav"):
        assert name in zero["files"], zero["files"]
    assert zero["hparams"] == 1 and zero["finalized"] == 1
    assert len(zero["steps"]) == STEPS + 1   # each step, then the epoch


def test_early_stopping_stops_both_ranks_at_one_epoch_and_both_resume(ranks):
    assert [r["early"]["stopped_at"] for r in ranks] == [2, 2]
    assert [(r["early"]["resumed_to"], r["early"]["resumed_step"]) for r in ranks] == [(3, 3)] * 2


def test_predict_returns_loader_order_with_the_ragged_tail(ranks, jax_side):
    """9 frames over 2 ranks: 5 a rank (frame 0 wrapped onto rank 1), batches
    of 2, the last a ragged 1; every rank returns 4, 4 and 2 rows, loader
    positions 0-8 and the wrapped 0, as JAX's multi-process predict does."""
    got = ranks[0]["predict"]
    assert [len(o) for o in got] == [4, 4, 2]
    for a, b in zip(got, ranks[1]["predict"]):
        assert torch.equal(a, b)
    frames = SPLITS["test"][list(range(9)) + [0]]
    task = vqvae_task(jax_side["init"], Path("unused"))
    with torch.no_grad():
        want = task.predict_step(ArrayDataModule({}, PREDICT_BATCH).on_after_batch_transfer(
            torch.from_numpy(frames)))
    assert (want[1:] - want[:-1]).abs().amax(dim=(1, 2)).min() > 1e-3   # frames decode apart
    np.testing.assert_allclose(torch.cat(got).numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_bert_code_ids_divide_by_the_global_largest_id(ranks):
    """JAX's rescale (msla_tpu/models/bert.py:250-253) on the global batch."""
    flat = jnp.asarray(np.concatenate([i.numpy() for i in BERT_IDS]).reshape(-1), jnp.float32)
    want = np.asarray(jnp.round(flat / jnp.maximum(flat.max(), 1.0) * (16 - 1))).astype(np.int64)
    got = np.concatenate([r["bert"]["sharded"].numpy() for r in ranks])
    np.testing.assert_array_equal(got, want)
    assert not torch.equal(ranks[0]["bert"]["local"], ranks[0]["bert"]["sharded"])


@pytest.mark.parametrize("key", ["aux", "router_grad"])
def test_moe_aux_and_router_gradient_match_jax_at_the_global_batch(ranks, moe_side, key):
    for r in ranks:
        np.testing.assert_allclose(r["moe"][key].numpy(), moe_side[key], rtol=1e-5,
                                   atol=1e-7 if key == "router_grad" else 0)
        assert r["moe"]["others"] == ["router"]
