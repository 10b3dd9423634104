"""The model axis on the CPU: 4 gloo ranks of the port on a (data, model) grid
against the JAX Trainer in this process, on the same weights, and against
the port's own data parallelism (the data axis alone) at the same global batch.

The ranks run once, through ``python -m msla_tpu_torch.parallel.launch
--nproc 4 --platform cpu`` (``tests/_torch_mp.py``), beside one 2-rank launch
of data parallelism alone; both run while this process computes the JAX
side. Every VQ-VAE run sees the global batch of 8 rows a step, 3 steps, the
JAX loader's batch i the rows of the data ranks' batches i; unshuffled,
masking off.

* VQ-VAE at (dp, mp) = (4, 1) with ``zero1`` and with ``fsdp``, at (2, 2)
  with ``model_parallel=2`` and with ``fsdp`` too: each step's loss and
  perplexity (the global batch's code counts, summed over the data group)
  at rtol 1e-5, the epoch metrics at 1e-3, the parameters' moves within
  0.2·lr of the replicated JAX Trainer's where the first gradient is clear
  of 0 (ROADMAP.md §3's table); (2, 2) fsdp + tp also against the JAX
  Trainer with ``devices=4, model_parallel=2, fsdp=True``;
* bit-equal to the port's data-parallel run where the arithmetic is the
  same: zero1 and fsdp to 4 data ranks, the gathered tp leaves (and fsdp on
  them) to 2 data ranks;
* each rank holds its blocks of a sharded leaf and of its moments while the
  loop runs, as the layout rules give them; model peers end with the same
  state;
* predict at mp = 2: every row once, in loader order, the ragged tail and
  the wrapped duplicate;
* the MoE's aux loss and gradients at mp = 2, experts split over the model
  axis, against JAX at the global batch;
* the MoE transformer at (2, 2), dropout 0, against the replicated JAX
  Trainer; it and the dense transformer (the row-parallel FFN) against the
  port's 2 data ranks, within 0.05·lr where the first gradient is clear of
  0 and the metrics within rtol 1e-5 (sums in another order);
* checkpoints: the file written at (2, 2) under fsdp + tp holds whole
  tensors, the unsharded run's keys and shapes, equal to the gathered state;
  it resumes under (2, 2) bit-equal to an uninterrupted fit, and under (4, 1)
  zero1 and in one process near it (rtol 1e-5); a JAX ``.ckpt`` loads under
  (2, 2) with its weights and Adam moments.
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

from _torch_dp import CFG, PREDICT_BATCH, vqvae_task
from _torch_mp import B, EXPERTS, GLOBAL, STEPS, TRANSFORMER, Arrays, stems, vqvae_fit
from msla_tpu.data.datamodule import SlakhDataModule as JaxSlakhDataModule
from msla_tpu.data.transform import Quantize as JaxQuantize
from msla_tpu.models.transformer import TransformerTask as JaxTransformerTask
from msla_tpu.models.vqvae import VQVAETask as JaxVQVAETask
from msla_tpu.nn.moe import MoEFFN as JaxMoEFFN
from msla_tpu.train.loggers import Logger as JaxLogger
from msla_tpu.train.trainer import Trainer as JaxTrainer
from msla_tpu_torch.models.transformer import TransformerTask
from msla_tpu_torch.parallel.sharding import kernel_names, param_spec, opt_spec
from msla_tpu_torch.train.checkpoint import load_checkpoint
from msla_tpu_torch.utils.jax_compat import (transformer_state_dict_from_jax,
                                             vqvae_state_dict_from_jax)

REPO = Path(__file__).resolve().parent.parent
T = 800
LAYERS = CFG["num_residual_layer"]
MOE_X = dict(rows=8, s=8, m=16, f=32)
SPLITS = dict(train=stems(STEPS * GLOBAL, T, 0), val=stems(GLOBAL, T, 1), test=stems(9, T, 2))
T_FRAME = TRANSFORMER["sample_rate"] * TRANSFORMER["frame_length"]
T_SPLITS = dict(t_train=0.3 * np.random.default_rng(10).standard_normal(
                    (STEPS * GLOBAL, 4, T_FRAME)).astype(np.float32),
                t_val=0.3 * np.random.default_rng(11).standard_normal(
                    (GLOBAL, 4, T_FRAME)).astype(np.float32))
VQ_RUNS = ["zero1", "fsdp", "mp", "mp_fsdp"]
LAYOUT = dict(zero1=dict(mp=1, dp=4, zero1=True), fsdp=dict(mp=1, dp=4, fsdp=True),
              mp=dict(mp=2, dp=2), mp_fsdp=dict(mp=2, dp=2, fsdp=True),
              moe=dict(mp=2, dp=2), dense=dict(mp=2, dp=2))


class JaxArrays(JaxSlakhDataModule):
    def __init__(self, splits, batch_size, sample_rate=CFG["sample_rate"], duration=1, **kw):
        super().__init__(train_dir="train", val_dir="val", test_dir="test",
                         target_sample_rate=sample_rate, target_sample_duration=duration,
                         max_duration=120, maximum_dataset_size=100, batch_size=batch_size,
                         num_workers=0, **kw)
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


def _jax_vqvae(tmp, **kw):
    """The JAX VQ-VAE Trainer's fit at the global batch, and the init (seed
    0) it drew."""
    task = JaxVQVAETask(**CFG, checkpoint_dir=str(tmp), codebook_file=str(tmp / "cb.csv"))
    drawn = {}

    def init_variables(rng, batch, _init=jax.jit(task.init_variables)):
        variables = _init(rng, batch)   # jitted: the init's eager ops cost seconds
        drawn.update(jax.device_get(variables))   # the step donates the device copy
        return variables

    task.init_variables = init_variables
    recorder = JaxRecorder()
    trainer = JaxTrainer(default_root_dir=str(tmp), max_epochs=1, accelerator="cpu",
                         enable_progress_bar=False, log_every_n_steps=1, seed=0,
                         logger=[recorder], **kw)
    trainer.fit(task, JaxArrays(SPLITS, GLOBAL))
    return task, trainer, recorder, drawn["params"]


def _jax_checkpoint(path, params):
    """A JAX msgpack .ckpt of ``params`` and ``optax.adam``'s state with
    seeded moments, at epoch 1, step 3, as the JAX Trainer writes it."""
    import optax

    from msla_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint

    rng = np.random.default_rng(7)
    mu, nu = (jax.tree_util.tree_map(
        lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32), params)
        for scale in (1e-3, 1e-6))
    nu = jax.tree_util.tree_map(np.abs, nu)
    state = (optax.ScaleByAdamState(count=np.int32(STEPS), mu=mu, nu=nu), optax.EmptyState())
    jax_save_checkpoint(path, params=params, opt_state=state, epoch=1, global_step=STEPS)
    to_port = lambda tree: vqvae_state_dict_from_jax(tree, LAYERS)  # noqa: E731
    return dict(params=to_port(params), mu=to_port(mu), nu=to_port(nu), count=STEPS)


def _launch(root: Path, nproc: int, launch: str) -> subprocess.Popen:
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(REPO), str(REPO / "tests")]),
           "OMP_NUM_THREADS": "1"}
    return subprocess.Popen(
        [sys.executable, "-m", "msla_tpu_torch.parallel.launch", "--nproc", str(nproc),
         "--platform", "cpu", "--", str(REPO / "tests" / "_torch_mp.py"), str(root), launch],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)


def _jax_moe_fit(tmp, teacher, late: dict, late_path: Path):
    """The replicated JAX Trainer's MoE transformer fit at the global batch.
    The init it draws (seed 0) goes to the ranks at once, in ``late_path``
    with ``late``, written whole and renamed; the ranks' transformer cases
    wait for it."""
    task = JaxTransformerTask(**TRANSFORMER, checkpoint_dir=str(tmp), moe_experts=EXPERTS)
    drawn = {}

    def init_variables(rng, batch, _init=jax.jit(task.init_variables)):
        variables = _init(rng, batch)
        drawn["init"] = transformer_state_dict_from_jax(jax.device_get(variables["params"]),
                                                        TRANSFORMER["num_layers"])
        torch.save(dict(late, moe_init=drawn["init"]), late_path.with_suffix(".tmp"))
        late_path.with_suffix(".tmp").rename(late_path)
        return variables

    task.init_variables = init_variables
    trainer = JaxTrainer(default_root_dir=str(tmp), max_epochs=1, accelerator="cpu",
                         enable_progress_bar=False, log_every_n_steps=0, seed=0)
    trainer.fit(task, JaxArrays(
        {"train": T_SPLITS["t_train"], "val": T_SPLITS["t_val"]}, GLOBAL,
        sample_rate=TRANSFORMER["sample_rate"], duration=TRANSFORMER["frame_length"],
        quantizer=teacher, quantized_latents=True))
    return trainer, drawn["init"]


def _moe_module():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((MOE_X["rows"], MOE_X["s"], MOE_X["m"])).astype(np.float32)
    moe = JaxMoEFFN(MOE_X["m"], MOE_X["f"], EXPERTS, num_selected=2)
    params = jax.jit(moe.init)(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    return moe, x, jax.device_get(params)


def _moe_aux(moe, x, params):
    def loss(p):
        y, state = moe.apply({"params": p}, jnp.asarray(x), mutable=["losses"])
        aux = jax.tree_util.tree_leaves(state["losses"])[0]
        return aux + jnp.mean(jnp.square(y)), aux

    (_, aux), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return dict(aux=float(aux), grads={k: np.asarray(v) for k, v in jax.device_get(grads).items()})


def _first_gradients(task, batch) -> dict[str, torch.Tensor]:
    """The port's gradient of the first step's loss, one process: it selects
    where a gradient is clear of 0 (the plain path equals JAX's gradients
    within 1e-5, tests/test_torch_train.py and test_torch_transformer.py)."""
    task.net.zero_grad()
    task.loss_fn(batch, None)[0].backward()
    return {n: p.grad.clone() for n, p in task.net.named_parameters()}


def _transformer_task(init: dict | None, experts: int) -> TransformerTask:
    task = TransformerTask(**TRANSFORMER, checkpoint_dir="unused", latent_channels=8,
                           moe_experts=experts, device="cpu")
    if init is not None:
        task.net.load_state_dict(init)
    return task


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """The JAX side and both launches' ranks: the ranks start once their
    inputs are ready and run while the JAX fits compute."""
    tmp = tmp_path_factory.mktemp("jax_mp")
    jax_vq, replicated, recorder, init_params = _jax_vqvae(tmp / "replicated")
    init = vqvae_state_dict_from_jax(init_params, LAYERS)
    jax_ckpt = tmp / "jax.ckpt"
    ckpt = _jax_checkpoint(jax_ckpt, init_params)
    root = tmp_path_factory.mktemp("ranks")
    torch.save(dict(init=init, jax_ckpt=str(jax_ckpt),
                    **{k: torch.from_numpy(v) for k, v in {**SPLITS, **T_SPLITS}.items()}),
               root / "inputs.pt")
    procs = {"model": _launch(root, 4, "model"), "data": _launch(root, 2, "data")}
    try:
        moe_module, moe_x, moe_params = _moe_module()
        late = dict(moe_params={k: torch.from_numpy(np.array(v)) for k, v in moe_params.items()},
                    moe_x=torch.from_numpy(moe_x))
        raw0 = T_SPLITS["t_train"][:GLOBAL]
        teacher = JaxQuantize(jax_vq.net, {"params": init_params})   # the VQ-VAE's init, frozen
        moe_trainer, moe_init = _jax_moe_fit(tmp, teacher, late, root / "late.pt")
        _, fsdp_tp, _, fsdp_init = _jax_vqvae(tmp / "fsdp_tp", devices=4, model_parallel=2,
                                              fsdp=True)
        assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(fsdp_init),
                                                        jax.tree_util.tree_leaves(init_params)))
        moe = dict(x=moe_x, **_moe_aux(moe_module, moe_x, moe_params))

        raw = torch.from_numpy(raw0)
        t_batch = (vqvae_task(init, tmp / "teacher").get_quantized(raw).quantized, raw)
        first_grads = {"moe": _first_gradients(_transformer_task(moe_init, EXPERTS), t_batch),
                       "dense": _first_gradients(_transformer_task(None, 0), t_batch)}
        vq_batch = Arrays({}, GLOBAL).on_after_batch_transfer(torch.from_numpy(
            SPLITS["train"][:GLOBAL]))
        grads = _first_gradients(vqvae_task(init, tmp / "port"), vq_batch)
        logs = {k: p.communicate(timeout=300)[0] for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    for k, p in procs.items():
        assert p.returncode == 0, logs[k][-8000:]
    to_port = lambda tree: vqvae_state_dict_from_jax(jax.device_get(tree), LAYERS)  # noqa: E731
    return dict(
        root=root, init=init, grads=grads, steps=recorder.metrics, jax_ckpt=ckpt,
        replicated=dict(final=to_port(replicated.state.params),
                        callback_metrics=replicated.callback_metrics),
        fsdp_tp=dict(final=to_port(fsdp_tp.state.params),
                     callback_metrics=fsdp_tp.callback_metrics),
        moe_fit=dict(init=moe_init, grads=first_grads["moe"],
                     final=transformer_state_dict_from_jax(
                         jax.device_get(moe_trainer.state.params), TRANSFORMER["num_layers"]),
                     callback_metrics=moe_trainer.callback_metrics),
        first_grads=first_grads, moe=moe,
        model=[torch.load(root / f"model{r}.pt", weights_only=False) for r in range(4)],
        data=[torch.load(root / f"data{r}.pt", weights_only=False) for r in range(2)])


def _moves_within(state, start, final, grads, lr, clear=1e-3, moved_past_lr=True):
    for key, value in state.items():
        g = grads[key].abs()
        sure = g > clear * g.max()
        moved, want = value - start[key], final[key] - start[key]
        assert sure.any(), key
        assert want[sure].abs().max() > lr or not moved_past_lr, key
        np.testing.assert_allclose(moved[sure].numpy(), want[sure].numpy(), rtol=0,
                                   atol=0.2 * lr, err_msg=key)


def test_the_grid_lays_the_ranks_out_as_jax(sides):
    """Rank r is data index r // 2 and model index r % 2, as make_mesh's
    reshape(n // mp, mp) lays the devices out."""
    got = [(r["rank"], r["world"], r["moe_aux"]["data_index"], r["moe_aux"]["model_index"])
           for r in sides["model"]]
    assert got == [(0, 4, 0, 0), (1, 4, 0, 1), (2, 4, 1, 0), (3, 4, 1, 1)]
    assert [r["mp"]["global_step"] for r in sides["model"]] == [STEPS] * 4


@pytest.mark.parametrize("key", ["train/loss", "train/perplexity"])
@pytest.mark.parametrize("run", VQ_RUNS)
def test_each_step_matches_jax_at_the_global_batch(sides, run, key):
    want = [(step, m[key]) for step, m in sides["steps"][:STEPS]]
    got = [(step, m[key]) for step, m in sides["model"][0][run]["steps"][:STEPS]]
    if key == "train/perplexity":   # more than one code: the global count matters
        assert min(v for _, v in want) > 1.05, want
    assert [s for s, _ in got] == [s for s, _ in want] == list(range(1, STEPS + 1))
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-5)


@pytest.mark.parametrize("run,jax_run", [(r, "replicated") for r in VQ_RUNS]
                         + [("mp_fsdp", "fsdp_tp")])
def test_epoch_metrics_match_jax(sides, run, jax_run):
    want = sides[jax_run]["callback_metrics"]
    got = sides["model"][0][run]["callback_metrics"]
    assert set(got) == set(want) and len(want) == 21
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-3, err_msg=k)


@pytest.mark.parametrize("run,jax_run", [(r, "replicated") for r in VQ_RUNS]
                         + [("mp_fsdp", "fsdp_tp")])
def test_parameter_moves_match_jax(sides, run, jax_run):
    _moves_within(sides["model"][0][run]["state"], sides["init"], sides[jax_run]["final"],
                  sides["grads"], CFG["learning_rate"])


@pytest.mark.parametrize("run,reference", [("zero1", "dp4"), ("fsdp", "dp4"), ("mp", "dp2"),
                                           ("mp_fsdp", "dp2")])
def test_bit_equal_to_data_parallel_at_the_same_global_batch(sides, run, reference):
    """zero1 and fsdp on 4 data ranks against data parallelism on 4 ranks; the
    gathered tp leaves at (2, 2) against 2 data-parallel ranks at twice the
    rank's batch."""
    ref = (sides["model"][0] if reference == "dp4" else sides["data"][0])[reference]
    got = sides["model"][0][run]
    for key, value in ref["state"].items():
        assert torch.equal(got["state"][key], value), key
    assert got["callback_metrics"] == ref["callback_metrics"]
    assert got["steps"] == ref["steps"]


def _held(name, shape, mp, dp, kernel, zero1=False, fsdp=False):
    spec = param_spec(name, shape, kernel, mp, dp, fsdp)
    sizes = {"data": dp, "model": mp, None: 1}
    held = tuple(n // sizes[a] for n, a in zip(shape, spec))
    moment = opt_spec(spec, shape, kernel, dp, zero1)
    return held, tuple(n // sizes[a] for n, a in zip(shape, moment))


@pytest.mark.parametrize("run", VQ_RUNS + ["moe", "dense"])
def test_sharded_leaves_are_held_as_shards(sides, run):
    """While the loop runs a rank holds its block of each parameter and of
    its moments, as the layout rules give them; whole again after ``fit``."""
    layout = LAYOUT[run]
    if run in ("moe", "dense"):
        net = _transformer_task(None, EXPERTS if run == "moe" else 0).net
    else:
        net = vqvae_task(sides["init"], Path("unused")).net
    kernels = kernel_names(net)
    got = sides["model"][1][run]
    split = 0
    for name, p in net.named_parameters():
        held, moment = _held(name, tuple(p.shape), layout["mp"], layout["dp"], name in kernels,
                             layout.get("zero1", False), layout.get("fsdp", False))
        assert got["params"][name] == held and got["moments"][name] == moment, name
        assert tuple(got["state"][name].shape) == tuple(p.shape), name
        split += moment != tuple(p.shape)
    assert split >= 1
    if run in ("mp", "mp_fsdp"):
        cb = "vector_quantizer.codebook.weight"
        assert got["params"][cb] == ((8, 8) if run == "mp" else (8, 4))
    if run == "moe":
        assert got["params"]["layer0.moe.w1"] == (EXPERTS // 2, 32, 2048)
        assert got["params"]["layer0.moe.router"] == (32, EXPERTS)
    if run == "dense":
        assert got["params"]["layer0.linear1.weight"] == (1024, 32)
        assert got["params"]["layer0.linear2.weight"] == (32, 1024)


@pytest.mark.parametrize("run", VQ_RUNS + ["moe", "dense"])
def test_every_rank_ends_with_the_same_state(sides, run):
    ranks = sides["model"]
    for key, value in ranks[0][run]["state"].items():
        for r in ranks[1:]:
            assert torch.equal(r[run]["state"][key], value), (key, r["rank"])
    for r in ranks[1:]:
        assert r[run]["callback_metrics"] == ranks[0][run]["callback_metrics"]


def test_predict_returns_every_row_once_in_loader_order_at_mp2(sides):
    """9 frames over 2 data indices: 5 each (frame 0 wrapped onto index 1),
    batches of 2, the last a ragged 1: every rank returns 4, 4 and 2 rows,
    loader positions 0-8 and the wrapped 0 (model peers counted once)."""
    got = sides["model"][0]["predict"]
    assert [len(o) for o in got] == [4, 4, 2]
    for r in sides["model"][1:]:
        for a, b in zip(got, r["predict"]):
            assert torch.equal(a, b)
    frames = SPLITS["test"][list(range(9)) + [0]]
    task = vqvae_task(sides["init"], Path("unused"))
    with torch.no_grad():
        want = task.predict_step(Arrays({}, PREDICT_BATCH).on_after_batch_transfer(
            torch.from_numpy(frames)))
    assert (want[1:] - want[:-1]).abs().amax(dim=(1, 2)).min() > 1e-3   # frames decode apart
    np.testing.assert_allclose(torch.cat(got).numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("what", ["aux", "router", "experts"])
def test_moe_aux_and_gradients_match_jax_at_mp2(sides, what):
    """The aux loss from the global batch's means (summed over the data
    group), the router's gradient whole on every rank and each rank's
    experts' gradients, against JAX at the global batch."""
    moe = sides["moe"]
    for r in sides["model"]:
        got = r["moe_aux"]
        if what == "aux":
            np.testing.assert_allclose(got["aux"].item(), moe["aux"], rtol=1e-5)
        elif what == "router":
            np.testing.assert_allclose(got["grads"]["router"].numpy(), moe["grads"]["router"],
                                       rtol=1e-5, atol=1e-7)
        else:
            part = EXPERTS // 2
            mine = slice(got["model_index"] * part, (got["model_index"] + 1) * part)
            for name in ("w1", "b1", "w2", "b2"):
                assert got["grads"][name].shape[0] == part
                np.testing.assert_allclose(got["grads"][name].numpy(), moe["grads"][name][mine],
                                           rtol=1e-5, atol=1e-7, err_msg=name)


def test_moe_transformer_at_2x2_matches_the_jax_trainer(sides):
    got, want = sides["model"][0]["moe"], sides["moe_fit"]
    assert set(got["callback_metrics"]) == set(want["callback_metrics"])
    for k, v in want["callback_metrics"].items():
        np.testing.assert_allclose(got["callback_metrics"][k], v, rtol=1e-3, err_msg=k)
    _moves_within(got["state"], want["init"], want["final"], want["grads"],
                  TRANSFORMER["learning_rate"], clear=1e-2, moved_past_lr=False)


@pytest.mark.parametrize("run", ["moe", "dense"])
def test_transformer_at_2x2_near_data_parallel(sides, run):
    """The expert-parallel combine and the row-parallel FFN sum in another
    order than 2 data ranks' whole layers: after 3 steps the parameters
    within 0.05·lr where the first gradient is clear of 0 (above 1e-2 of
    its tensor's largest; Adam's steps on a gradient near 0 follow its
    rounding, and the attention's q and k gradients cancel to near 0 in
    places), the metrics within rtol 1e-5. The attention's key biases are
    left out: their gradient is 0 in exact arithmetic (q·b_k is the same for
    every key of a row, and the softmax drops it), so all of it is rounding."""
    got, ref = sides["model"][0][run], sides["data"][0][run]
    grads = sides["first_grads"][run]
    for key, value in ref["state"].items():
        if key.endswith("k_proj.bias"):
            continue
        g = grads[key].abs()
        sure = g > 1e-2 * g.max()
        assert sure.any(), key
        np.testing.assert_allclose(got["state"][key][sure].numpy(), value[sure].numpy(),
                                   rtol=0, atol=0.05 * TRANSFORMER["learning_rate"],
                                   err_msg=key)
    for k, v in ref["callback_metrics"].items():
        np.testing.assert_allclose(got["callback_metrics"][k], v, rtol=1e-5, err_msg=k)


def test_checkpoint_holds_whole_tensors_equal_to_the_gathered_state(sides):
    root = sides["root"] / "model"
    last = load_checkpoint(root / "ckpt" / "last.ckpt")
    gathered = load_checkpoint(root / "gathered.ckpt")
    net = vqvae_task(sides["init"], Path("unused")).net
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    first = sides["model"][0]["ckpt"]["first"]
    assert {k: tuple(v.shape) for k, v in last["state_dict"].items()} == shapes
    for key, value in first["state"].items():
        assert torch.equal(last["state_dict"][key], value), key
        assert torch.equal(gathered["state_dict"][key], value), key
    names = [n for n, _ in net.named_parameters()]
    assert sorted(last["opt_state"]["state"]) == list(range(len(names)))
    for index, entry in last["opt_state"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert tuple(entry[k].shape) == shapes[names[index]]
            assert torch.equal(entry[k], gathered["opt_state"]["state"][index][k])
        assert float(entry["step"]) == STEPS
    assert last["global_step"] == STEPS and last["epoch"] == 1


@pytest.mark.parametrize("layout", ["again", "zero1", "one_process"])
def test_the_checkpoint_resumes_under_another_layout(sides, layout, tmp_path):
    """Written at (2, 2) under fsdp + tp after one epoch; a second epoch
    under (2, 2) again ends bit-equal to an uninterrupted fit, under (4, 1)
    zero1 and in one process at the global batch within rtol 1e-5."""
    whole = sides["model"][0]["ckpt"]["whole"]
    if layout == "one_process":
        fit = vqvae_fit(dict(init=sides["init"], train=SPLITS["train"], val=SPLITS["val"]),
                        tmp_path, "one", GLOBAL, epochs=2,
                        ckpt_path=str(sides["root"] / "model" / "ckpt" / "last.ckpt"))
    else:
        fit = sides["model"][0]["ckpt"][layout]
    assert fit["global_step"] == whole["global_step"] == 2 * STEPS
    for key, value in whole["state"].items():
        if layout == "again":
            assert torch.equal(fit["state"][key], value), key
        else:
            np.testing.assert_allclose(fit["state"][key].numpy(), value.numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=key)
    if layout == "again":
        assert fit["steps"] == whole["steps"][STEPS + 1:]


def test_a_jax_checkpoint_loads_under_2x2(sides):
    """The JAX Trainer's msgpack .ckpt restored by ``fit`` at (2, 2) under
    fsdp + tp: the weights and Adam's moments, gathered back whole."""
    got = sides["model"][0]["ckpt"]["from_jax"]
    want = sides["jax_ckpt"]
    assert got["epoch"] == 1
    for key, value in want["params"].items():
        np.testing.assert_array_equal(got["state"][key].numpy(), value.numpy(), err_msg=key)
    written = load_checkpoint(sides["root"] / "model" / "from_jax.ckpt")
    names = [n for n, _ in vqvae_task(sides["init"], Path("unused")).net.named_parameters()]
    for index, entry in written["opt_state"]["state"].items():
        name = names[index]
        np.testing.assert_array_equal(entry["exp_avg"].numpy(), want["mu"][name].numpy(), name)
        np.testing.assert_array_equal(entry["exp_avg_sq"].numpy(), want["nu"][name].numpy(),
                                      name)
        assert float(entry["step"]) == want["count"]
