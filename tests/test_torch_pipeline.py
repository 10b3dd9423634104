"""Pipeline parallelism on the CPU: 4 gloo ranks of the port's GPipe schedule
(``msla_tpu_torch.parallel.pipeline``) against the JAX package's sequential
functions in this process, on the JAX package's inits.

The ranks run once, through ``python -m msla_tpu_torch.parallel.launch
--nproc 4 --platform cpu`` (``tests/_torch_pp.py``), while this process
computes the JAX side. No JAX pipelined function runs here: the JAX tests
(``tests/test_pipeline.py``, ``tests/test_parallel.py``) hold those equal to
``net.apply``, ``bert.apply``, ``task.loss_fn`` and the Trainer at
``pipeline_parallel=1``, which these tests hold the port to.

* ``spmd_pipeline`` on toy layers at (dp, pp) = (2, 2) and (1, 4), n_micro 2
  and 4: the forward within 1e-6 and the gradients (after the model group's
  sum and the data mean) within 1e-5 of ``jax.value_and_grad`` of the
  sequential stack;
* ``pipelined_transformer_apply`` (``tests/test_pipeline.py``'s small net)
  against ``net.apply`` at 2e-5, its loss at 1e-6 and gradients at (1e-4,
  1e-5); ``pipelined_bert_apply``'s logits and MLM hidden, ragged masks,
  against ``bert.apply`` at 2e-5; ``AudioBertTask.pipeline_loss_fn`` at (2,
  2) against JAX's ``loss_fn`` at rtol 1e-5;
* ``Trainer(pipeline_parallel=2, pipeline_microbatches=2)`` at (2, 2): the
  transformer on ``tests/test_parallel.py``'s data against the JAX Trainer
  at ``pipeline_parallel=1`` (ROADMAP.md §3's transformer tolerances) and
  the port's (4, 1) data parallelism (JAX's pp-vs-dp rtol 1e-3, atol 1e-4);
  Audio-BERT 3 steps against the port's (4, 1) run within 1e-6 (SI-SDR
  1e-5), its first loss JAX's ``loss_fn``'s;
* ``zero1`` bit-equal, ``remat`` gradients bit-equal, and
  ``accumulate_grad_batches=2`` within 1e-6 of twice the batch (the
  losses; the gradients within 1e-5 of each tensor's largest); dropout
  live, reproducible and the same bits at pp = 1, 2 and 4; the checkpoint
  written at (2, 2) whole, its resume bit-equal; JAX's ``ValueError``s.
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

from _torch_pp import (AB, AB_BATCH, AB_BERT, AB_STEPS, BERT, FIT, FIT_BATCH, FIT_EPOCHS, NET,
                       NET_RUNS, TOY, TOY_RUNS, fake_ids)
from msla_tpu.models.bert import AudioBertTask as JaxAudioBertTask
from msla_tpu.models.transformer import TransformerTask as JaxTransformerTask
from msla_tpu.nn.bert import BertConfig as JaxBertConfig
from msla_tpu.nn.bert import BertForMaskedLM as JaxBertForMaskedLM
from msla_tpu.nn.transformer_net import TransformerQuantizerNet as JaxNet
from msla_tpu.parallel.pipeline import stack_layer_params as jax_stack
from msla_tpu.train.trainer import Trainer as JaxTrainer
from msla_tpu_torch.models.transformer import TransformerTask
from msla_tpu_torch.parallel.pipeline import (stack_layer_params, stage_layers,
                                              unstack_layer_params)
from msla_tpu_torch.train.checkpoint import load_checkpoint
from msla_tpu_torch.utils.jax_compat import (audio_bert_state_dict_from_jax,
                                             bert_state_dict_from_jax,
                                             transformer_state_dict_from_jax)

REPO = Path(__file__).resolve().parent.parent
LR = FIT["learning_rate"]


def _toy():
    rng = np.random.default_rng(0)
    d = TOY["d"]
    params = {f"layer{i}": {"w": (rng.standard_normal((d, d)) * 0.3).astype(np.float32),
                            "b": (rng.standard_normal(d) * 0.1).astype(np.float32)}
              for i in range(TOY["layers"])}
    x = rng.standard_normal((TOY["batch"], 3, d)).astype(np.float32)
    return params, x


def _toy_reference(params, x):
    def loss(p):
        h = jnp.asarray(x)
        for i in range(TOY["layers"]):
            h = jnp.tanh(h @ p[f"layer{i}"]["w"] + p[f"layer{i}"]["b"])
        return jnp.mean(jnp.square(h)), h

    (_, y), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return np.asarray(y), {f"{n}.{k}": np.asarray(v) for n, sub in grads.items()
                           for k, v in sub.items()}


class _Batches:
    """tests/test_parallel.py:440-456's datamodule: (quantized, stems)."""

    def __init__(self, data, batch_size):
        self.batches = [data[i:i + batch_size]
                        for i in range(0, len(data) - batch_size + 1, batch_size)]

    def train_dataloader(self):
        return list(self.batches)

    def val_dataloader(self):
        return list(self.batches)

    def on_after_batch_transfer(self, batch):
        return batch[:, :2, :].reshape(batch.shape[0], 8, 32), batch


def _jax_fit_task(tmp):
    return JaxTransformerTask(**FIT, checkpoint_dir=str(tmp))


def _jax_audio_bert(tmp, codebook_csv):
    task = JaxAudioBertTask(AB["learning_rate"], str(tmp / "ab"), codebook_csv,
                            AB["sample_rate"], AB["frame_length"], AB["num_embedding"],
                            mask_prob=0.0)
    task.config = JaxBertConfig(**AB_BERT)
    task.bert = JaxBertForMaskedLM(task.config)
    return task


def _launch(root: Path) -> subprocess.Popen:
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(REPO), str(REPO / "tests")]),
           "OMP_NUM_THREADS": "1"}
    return subprocess.Popen(
        [sys.executable, "-m", "msla_tpu_torch.parallel.launch", "--nproc", "4",
         "--platform", "cpu", "--", str(REPO / "tests" / "_torch_pp.py"), str(root)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)


def _put(root: Path, name: str, value: dict) -> None:
    """A rank input written whole, then renamed: the ranks wait for it."""
    torch.save(value, root / f"{name}.tmp")
    (root / f"{name}.tmp").rename(root / f"{name}.pt")


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """The ranks start on the data at once, and take each JAX init as this
    process draws it, then run while the JAX side computes."""
    tmp = tmp_path_factory.mktemp("jax_pp")
    root = tmp_path_factory.mktemp("ranks")
    rng = np.random.default_rng(2)
    toy_params, toy_x = _toy()
    q = rng.standard_normal((16, 8, 32)).astype(np.float32)
    target = rng.standard_normal((16, 4, 128)).astype(np.float32)
    ids = np.random.default_rng(5).integers(0, 64, (16, 12)).astype(np.int32)
    mask = (np.arange(12)[None, :] < (6 + np.arange(16) % 7)[:, None]).astype(np.int32)
    fit_data = np.random.default_rng(7).standard_normal((16, 4, 128)).astype(np.float32)
    codebook_csv = str(tmp / "codebook.csv")
    np.savetxt(codebook_csv, np.random.default_rng(8).standard_normal((16, 8)), delimiter=",",
               header=",".join(map(str, range(8))), comments="")
    ab_train = (np.random.default_rng(9).standard_normal((AB_BATCH * AB_STEPS, 4, 2048)) * 0.5
                ).astype(np.float32)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    _put(root, "inputs", dict(
        toy_params={n: {k: t(v) for k, v in sub.items()} for n, sub in toy_params.items()},
        toy_x=t(toy_x), net_q=t(q), net_target=t(target), bert_ids=t(ids).long(),
        bert_mask=t(mask), fit_train=fit_data, codebook_csv=codebook_csv, ab_train=ab_train))
    proc = _launch(root)
    try:
        net = JaxNet(**NET)
        net_params = jax.device_get(jax.jit(lambda k, x: net.init(k, x, deterministic=True))(
            jax.random.PRNGKey(0), q)["params"])
        _put(root, "net", dict(net_init=transformer_state_dict_from_jax(net_params,
                                                                        NET["num_layers"])))
        bert = JaxBertForMaskedLM(JaxBertConfig(**BERT))
        bert_params = jax.device_get(jax.jit(lambda k, i: bert.init(k, i, deterministic=True))(
            jax.random.PRNGKey(0), ids)["params"])
        _put(root, "bert", dict(bert_init=bert_state_dict_from_jax(bert_params)))
        fit_task = _jax_fit_task(tmp)
        fit_init = jax.jit(fit_task.init_variables)   # jitted: the init's eager ops cost seconds
        batch0 = _Batches(fit_data, FIT_BATCH).on_after_batch_transfer(jnp.asarray(fit_data[:8]))
        fit_params = jax.device_get(fit_init(jax.random.PRNGKey(0), batch0)["params"])
        _put(root, "fit", dict(fit_init=transformer_state_dict_from_jax(fit_params,
                                                                        FIT["num_layers"])))
        ab_batch = (jnp.asarray(fake_ids(ab_train[:AB_BATCH]), jnp.int32),
                    jnp.asarray(ab_train[:AB_BATCH]))
        ab_task = _jax_audio_bert(tmp, codebook_csv)
        ab_params = jax.device_get(jax.jit(ab_task.init_variables)(jax.random.PRNGKey(0),
                                                                   ab_batch)["params"])
        _put(root, "ab", dict(ab_init=audio_bert_state_dict_from_jax(ab_params)))

        toy_y, toy_grads = _toy_reference(toy_params, toy_x)
        net_y = np.asarray(jax.jit(lambda p, x: net.apply({"params": p}, x,
                                                          deterministic=True))(net_params, q))

        def net_loss(p):
            return jnp.mean(jnp.square(net.apply({"params": p}, q, deterministic=True) - target))

        loss, grads = jax.jit(jax.value_and_grad(net_loss))(net_params)
        bert_apply = jax.jit(lambda p, i, m, h: bert.apply({"params": p}, i, attention_mask=m,
                                                           deterministic=True,
                                                           return_mlm_hidden=h),
                             static_argnums=3)
        ab_loss = float(jax.jit(ab_task.loss_fn)(ab_params, ab_batch, jax.random.PRNGKey(3))[0])

        drawn = {}

        def init_variables(rng, batch):
            variables = fit_init(rng, batch)
            drawn.update(jax.device_get(variables))
            return variables

        fit_task.init_variables = init_variables
        trainer = JaxTrainer(default_root_dir=str(tmp), max_epochs=FIT_EPOCHS, accelerator="cpu",
                             enable_progress_bar=False, log_every_n_steps=0,
                             pipeline_parallel=1, pipeline_microbatches=2)
        trainer.fit(fit_task, _Batches(fit_data, FIT_BATCH))
        assert all(np.array_equal(a, b) for a, b in zip(
            jax.tree_util.tree_leaves(drawn["params"]), jax.tree_util.tree_leaves(fit_params)))

        port = TransformerTask(**FIT, checkpoint_dir=str(tmp), latent_channels=8, device="cpu")
        port.net.load_state_dict(transformer_state_dict_from_jax(fit_params, FIT["num_layers"]))
        raw = torch.from_numpy(fit_data[:FIT_BATCH])
        port.loss_fn((raw[:, :2, :].reshape(FIT_BATCH, 8, 32), raw), None)[0].backward()
        first_grads = {n: p.grad.clone() for n, p in port.net.named_parameters()}
        out = proc.communicate(timeout=300)[0]
    finally:
        if proc.poll() is None:   # the launcher stops its ranks on SIGTERM
            proc.terminate()
            proc.wait(timeout=30)
    assert proc.returncode == 0, out[-8000:]
    return dict(
        root=root, toy=dict(y=toy_y, grads=toy_grads),
        net=dict(y=net_y, loss=float(loss),
                 grads=transformer_state_dict_from_jax(jax.device_get(grads), NET["num_layers"])),
        bert={h: np.asarray(bert_apply(bert_params, ids, mask, h)) for h in (False, True)},
        ab_loss=ab_loss,
        fit=dict(init=transformer_state_dict_from_jax(fit_params, FIT["num_layers"]),
                 final=transformer_state_dict_from_jax(jax.device_get(trainer.state.params),
                                                       FIT["num_layers"]),
                 callback_metrics=trainer.callback_metrics, first_grads=first_grads),
        ranks=[torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(4)])


def _rows(ranks, key, run, field):
    """The global batch's rows from each data index's model index 0."""
    pp, _ = run
    dp = 4 // pp
    parts = [ranks[d * pp][key][run][field] for d in range(dp)]
    whole = torch.empty((sum(len(p) for p in parts),) + tuple(parts[0].shape[1:]))
    for d, part in enumerate(parts):
        whole[d::dp] = part
    return whole.numpy()


def test_stack_layer_params_matches_jax_and_round_trips():
    params, _ = _toy()
    names = list(params)
    flat = {f"{n}.{k}": torch.from_numpy(v) for n, sub in params.items() for k, v in sub.items()}
    stacked = stack_layer_params(flat, names)
    want = jax_stack(jax.tree_util.tree_map(jnp.asarray, params), names)
    for key in ("w", "b"):
        np.testing.assert_array_equal(stacked[key].numpy(), np.asarray(want[key]))
    back = unstack_layer_params(stacked, names)
    assert set(back) == set(flat) and all(torch.equal(back[k], flat[k]) for k in flat)
    assert [list(stage_layers(12, 4, s)) for s in range(4)] == [[0, 1, 2], [3, 4, 5],
                                                                [6, 7, 8], [9, 10, 11]]


@pytest.mark.parametrize("run", TOY_RUNS, ids=lambda r: f"pp{r[0]}-micro{r[1]}")
def test_spmd_pipeline_matches_the_sequential_stack(sides, run):
    ranks = sides["ranks"]
    every = [r["toy"][run]["y"] for r in ranks]
    np.testing.assert_allclose(_rows(ranks, "toy", run, "y"), sides["toy"]["y"], rtol=1e-6,
                               atol=1e-6)
    for r in ranks:   # model peers hold the last stage's output; every rank the same gradients
        assert torch.equal(r["toy"][run]["y"], every[(r["rank"] // run[0]) * run[0]])
        for k, v in sides["toy"]["grads"].items():
            np.testing.assert_allclose(r["toy"][run]["grads"][k].numpy(), v, rtol=1e-5,
                                       atol=1e-5, err_msg=k)


@pytest.mark.parametrize("run", NET_RUNS, ids=lambda r: f"pp{r[0]}-micro{r[1]}")
def test_pipelined_transformer_matches_jax(sides, run):
    ranks, want = sides["ranks"], sides["net"]
    np.testing.assert_allclose(_rows(ranks, "transformer", run, "y"), want["y"], rtol=2e-5,
                               atol=2e-5)
    dp = 4 // run[0]
    loss = np.mean([ranks[d * run[0]]["transformer"][run]["loss"].item() for d in range(dp)])
    np.testing.assert_allclose(loss, want["loss"], rtol=1e-6)
    for r in ranks:
        for k, v in want["grads"].items():
            np.testing.assert_allclose(r["transformer"][run]["grads"][k].numpy(), v.numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("hidden", [False, True], ids=["logits", "mlm_hidden"])
@pytest.mark.parametrize("run", NET_RUNS, ids=lambda r: f"pp{r[0]}-micro{r[1]}")
def test_pipelined_bert_matches_jax(sides, run, hidden):
    got = _rows(sides["ranks"], "bert", run, "hidden" if hidden else "logits")
    np.testing.assert_allclose(got, sides["bert"][hidden], rtol=2e-5, atol=2e-5)


def test_audio_bert_pipeline_loss_matches_jax_loss_fn(sides):
    ranks = sides["ranks"]
    for r in ranks:
        assert r["audio_bert"]["loss"].item() == r["audio_bert"]["plain"].item()
    loss = np.mean([ranks[d * 2]["audio_bert"]["loss"].item() for d in range(2)])
    np.testing.assert_allclose(loss, sides["ab_loss"], rtol=1e-5)


def _fit(sides, name, rank=0):
    return sides["ranks"][rank]["fits"][name]


def test_transformer_fit_matches_the_jax_trainer(sides):
    got, want = _fit(sides, "pp"), sides["fit"]
    assert got["global_step"] == 4 and set(got["callback_metrics"]) == set(want["callback_metrics"])
    for k, v in want["callback_metrics"].items():
        np.testing.assert_allclose(got["callback_metrics"][k], v, rtol=1e-3, err_msg=k)
    for key, value in got["state"].items():
        g = want["first_grads"][key].abs()
        sure = g > 1e-2 * g.max()
        assert sure.any(), key
        moved, wanted = value - want["init"][key], want["final"][key] - want["init"][key]
        np.testing.assert_allclose(moved[sure].numpy(), wanted[sure].numpy(), rtol=0,
                                   atol=0.2 * LR, err_msg=key)


def test_transformer_fit_near_data_parallel(sides):
    got, ref = _fit(sides, "pp"), _fit(sides, "dp")
    for key, value in ref["state"].items():
        np.testing.assert_allclose(got["state"][key].numpy(), value.numpy(), rtol=1e-3,
                                   atol=1e-4, err_msg=key)
    for k, v in ref["callback_metrics"].items():
        np.testing.assert_allclose(got["callback_metrics"][k], v, rtol=1e-3, err_msg=k)


@pytest.mark.parametrize("run", ["pp", "zero1", "remat", "resumed", "ab_pp"])
def test_every_rank_ends_with_the_same_state(sides, run):
    ranks = sides["ranks"]
    for r in ranks[1:]:
        for key, value in ranks[0]["fits"][run]["state"].items():
            assert torch.equal(r["fits"][run]["state"][key], value), (key, r["rank"])
        assert r["fits"][run]["callback_metrics"] == ranks[0]["fits"][run]["callback_metrics"]


def test_audio_bert_fit_matches_data_parallel_and_jax(sides):
    got, ref = _fit(sides, "ab_pp"), _fit(sides, "ab_dp")
    losses = [m["train/loss"] for _, m in got["steps"] if "validation/loss" not in m]
    assert len(losses) == AB_STEPS
    np.testing.assert_allclose(losses[0], sides["ab_loss"], rtol=1e-5)
    np.testing.assert_allclose([m["train/loss"] for _, m in got["steps"]],
                               [m["train/loss"] for _, m in ref["steps"]], rtol=1e-6)
    for k, v in ref["callback_metrics"].items():   # SI-SDR, a log of a ratio, at 1e-5
        np.testing.assert_allclose(got["callback_metrics"][k], v, atol=1e-7, err_msg=k,
                                   rtol=1e-5 if "si_sdr" in k else 1e-6)
    for key, value in ref["state"].items():
        np.testing.assert_allclose(got["state"][key].numpy(), value.numpy(), rtol=0, atol=1e-6,
                                   err_msg=key)


def test_zero1_is_bit_equal_to_the_pipeline_without_it(sides):
    got, ref = _fit(sides, "zero1"), _fit(sides, "pp")
    for key, value in ref["state"].items():
        assert torch.equal(got["state"][key], value), key
    assert got["steps"] == ref["steps"] and got["callback_metrics"] == ref["callback_metrics"]


def test_remat_gradients_are_bit_equal_at_live_dropout(sides):
    got, ref = _fit(sides, "remat"), _fit(sides, "no_remat")
    assert len(ref["grads"]) == 2
    for step_got, step_ref in zip(got["grads"], ref["grads"]):
        assert set(step_got) == set(step_ref)
        for key, value in step_ref.items():
            assert torch.equal(step_got[key], value), key
    for key, value in ref["state"].items():
        assert torch.equal(got["state"][key], value), key
    assert not torch.equal(ref["state"]["fc.weight"], _fit(sides, "first")["state"]["fc.weight"])


def test_accumulation_matches_twice_the_batch(sides):
    """Each step's loss within 1e-6, its gradients within 1e-5 of each
    tensor's largest (sums over the rows in another order). The attention's
    key biases are left out: their gradient is 0 in exact arithmetic (q·b_k
    is the same for every key of a row, and the softmax drops it), so all of
    it is rounding."""
    got, ref = _fit(sides, "accumulate"), _fit(sides, "twice")
    assert len(got["grads"]) == len(ref["grads"]) == 2
    for step_got, step_ref in zip(got["grads"], ref["grads"]):
        assert set(step_got) == set(step_ref)
        for key, value in step_ref.items():
            if key.endswith("k_proj.bias"):
                continue
            scale = value.abs().max().item()
            np.testing.assert_allclose(step_got[key].numpy(), value.numpy(), rtol=0,
                                       atol=1e-5 * scale, err_msg=key)
    np.testing.assert_allclose([m["train/loss"] for _, m in got["steps"]],
                               [m["train/loss"] for _, m in ref["steps"]], rtol=1e-6)


def test_dropout_is_live_reproducible_and_the_same_at_every_stage_count(sides):
    for r in sides["ranks"]:
        d = r["dropout"]
        assert torch.equal(d["live"][1], d["live"][2]) and torch.equal(d["live"][1], d["live"][4])
        assert torch.equal(d["again"], d["live"][2])
        assert not torch.allclose(d["live"][2], d["det"])
        assert not torch.allclose(d["live"][2], d["other"])
        assert torch.equal(d["live"][1], sides["ranks"][0]["dropout"]["live"][1])


def test_the_checkpoint_is_whole_and_resumes_bit_equal(sides):
    last = load_checkpoint(sides["root"] / "ckpt" / "last.ckpt")
    first = _fit(sides, "first")
    assert last["global_step"] == 2 and last["epoch"] == 1
    assert {k: tuple(v.shape) for k, v in last["state_dict"].items()} == \
        {k: tuple(v.shape) for k, v in first["state"].items()}
    for key, value in first["state"].items():
        assert torch.equal(last["state_dict"][key], value), key
    names = list(first["state"])
    for index, entry in last["opt_state"]["state"].items():
        assert tuple(entry["exp_avg"].shape) == tuple(first["state"][names[index]].shape)
    resumed, whole = _fit(sides, "resumed"), _fit(sides, "pp")
    assert resumed["global_step"] == whole["global_step"] == 4
    for key, value in whole["state"].items():
        assert torch.equal(resumed["state"][key], value), key
    assert resumed["steps"] == whole["steps"][3:]   # steps 3 and 4, and epoch 2's line


@pytest.mark.parametrize("case,match", [
    ("layers", "3 layers not divisible by 2 stages"),
    ("n_micro", "batch 8 not divisible by n_micro=3"),
    ("microbatch", "microbatch 1 not divisible by the data=2 mesh axis"),
    ("vqvae", "pipeline_parallel=2 but VQVAETask has no pipeline-parallel path"),
    ("moe", "pipeline_parallel and moe_experts both occupy the mesh `model` axis")])
def test_jax_value_errors(sides, case, match):
    for r in sides["ranks"]:
        assert match in (r["refusals"][case] or ""), r["refusals"][case]
