"""The Trainer's ``accumulate_grad_batches``, ``remat`` and ``profiler="jax"``
on the CPU, against the JAX Trainer where it has the same numbers to give.

* ``accumulate_grad_batches=2`` against the JAX Trainer on a 5-batch loader
  whose last batch is ragged: 3 optimizer steps in both (2 + 2 + a flushed
  1); the logged steps' metrics (the group's mean) and the epoch's metrics
  (weighted by each group's examples) within rtol 1e-3; the parameters'
  moves within 0.2·lr where the first group's mean gradient is clear of 0
  (as tests/test_torch_train.py holds 3 steps).
* k = 2 at batch B gives the gradient of k = 1 at batch 2B within 1e-5 of
  each gradient's largest entry (the mean-reduced losses make it the same
  math, fp32's sums over the batch's positions in another order: the final
  deconv's bias gradient, aten's CPU ``convolution_backward`` summed over
  B·T, parts by 6.1e-6 of its largest, and the JAX package's own k = 2 and
  2B gradients of this model part by up to 4.4e-6); the microbatches run
  the loss once each.
* ``remat=True``: the gradients and the stepped weights bit-equal to
  ``remat=False``'s on the same generator state, for the VQ-VAE (masking on)
  and the transformer at dropout 0.1, whose recomputed forward must draw
  the forward's masks; the loss runs twice a step (the recomputation).
* ``profiler="jax"`` writes a torch.profiler trace (Chrome's JSON) of ``fit``
  under ``default_root_dir/jax_trace``; "simple" times the steps; any other
  string profiles nothing, as in JAX.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msla_tpu.train.loggers import CSVLogger as JaxCSVLogger
from msla_tpu.train.trainer import Trainer as JaxTrainer
from msla_tpu_torch.data.transform import Quantize
from msla_tpu_torch.models.transformer import TransformerTask
from msla_tpu_torch.models.vqvae import VQVAETask
from msla_tpu_torch.train.loggers import CSVLogger
from msla_tpu_torch.train.trainer import Trainer
from msla_tpu_torch.utils.jax_compat import vqvae_state_dict_from_jax
from test_torch_train import CFG, JaxDM, PortDM, _batches, _port_task
from test_torch_train import jax_side  # noqa: F401  (the module fixture)

ACC = _batches(4, 50) + [_batches(1, 51)[0][:1]]  # 5 batches, the last of 1 row
VAL = _batches(1, 52)
LR = CFG["learning_rate"]


@pytest.fixture(scope="module")
def jax_accumulated(jax_side, tmp_path_factory):
    """The JAX Trainer's fit at accumulate_grad_batches=2, logging each step."""
    jax_task, params = jax_side
    root = tmp_path_factory.mktemp("acc")
    trainer = JaxTrainer(default_root_dir=str(root), max_epochs=1, accelerator="cpu",
                         enable_progress_bar=False, log_every_n_steps=1, seed=0,
                         accumulate_grad_batches=2, logger=[JaxCSVLogger(str(root / "jax"))])
    trainer.fit(jax_task, JaxDM(ACC, VAL))
    return dict(trainer=trainer, root=root, end=jax.device_get(trainer.state.params))


def _table(path):
    lines = path.read_text().splitlines()
    return lines[0].split(","), [[float(v) if v else np.nan for v in line.split(",")]
                                 for line in lines[1:]]


def test_accumulation_matches_the_jax_trainer(jax_side, jax_accumulated, tmp_path):
    jax_task, params = jax_side
    want = jax_accumulated["trainer"]
    task = _port_task(params, tmp_path)
    trainer = Trainer(max_epochs=1, accelerator="cpu", enable_progress_bar=False,
                      log_every_n_steps=1, seed=0, accumulate_grad_batches=2,
                      logger=[CSVLogger(str(tmp_path / "port"))])
    trainer.fit(task, PortDM(ACC, VAL))
    assert trainer.global_step == want.global_step == 3

    assert set(trainer.callback_metrics) == set(want.callback_metrics)
    for k, v in want.callback_metrics.items():
        np.testing.assert_allclose(trainer.callback_metrics[k], v, rtol=1e-3, err_msg=k)
    header, rows = _table(tmp_path / "port" / "metrics.csv")
    want_header, want_rows = _table(jax_accumulated["root"] / "jax" / "metrics.csv")
    assert header == want_header and len(rows) == len(want_rows) == 4  # 3 steps, the epoch
    np.testing.assert_allclose(np.array(rows), np.array(want_rows), rtol=1e-3)

    start = vqvae_state_dict_from_jax(params, CFG["num_residual_layer"])
    want_sd = vqvae_state_dict_from_jax(jax_accumulated["end"], CFG["num_residual_layer"])
    grad = jax.jit(jax.grad(lambda p, mix, x: jax_task.loss_fn(p, (mix, x),
                                                              jax.random.PRNGKey(0))[0]))
    dm = JaxDM(ACC, VAL)
    first = [grad(params, *dm.on_after_batch_transfer(jnp.asarray(raw))) for raw in ACC[:2]]
    mean = vqvae_state_dict_from_jax(jax.tree.map(lambda a, b: (a + b) / 2, *first),
                                     CFG["num_residual_layer"])
    for key, value in task.net.state_dict().items():
        g = mean[key].abs()
        sure = g > 1e-3 * g.max()
        moved, want_moved = value - start[key], want_sd[key] - start[key]
        assert want_moved[sure].abs().max() > LR, key
        np.testing.assert_allclose(moved[sure].numpy(), want_moved[sure].numpy(), rtol=0,
                                   atol=0.2 * LR, err_msg=key)


def _counted(task) -> list:
    calls = []
    loss_fn = task.loss_fn

    def counting(*args, **kw):
        calls.append(1)
        return loss_fn(*args, **kw)

    task.loss_fn = counting
    return calls


def _one_step(task, dm, **kw) -> dict[str, torch.Tensor]:
    """One optimizer step of fit; the gradients it stepped on."""
    Trainer(max_epochs=1, accelerator="cpu", enable_progress_bar=False, seed=0,
            limit_val_batches=1, **kw).fit(task, dm)
    return {k: p.grad.clone() for k, p in task.net.named_parameters() if p.grad is not None}


def test_k2_at_b_is_k1_at_2b(jax_side, tmp_path):
    _, params = jax_side
    a, b = ACC[0], ACC[1]
    task = _port_task(params, tmp_path)
    calls = _counted(task)
    got = _one_step(task, PortDM([a, b], VAL), accumulate_grad_batches=2)
    assert len(calls) == 2
    want = _one_step(_port_task(params, tmp_path), PortDM([np.concatenate([a, b])], VAL))
    assert got.keys() == want.keys() and len(got) == len(list(task.net.parameters()))
    for key, g in want.items():
        np.testing.assert_allclose(got[key].numpy(), g.numpy(), rtol=0,
                                   atol=1e-5 * g.abs().max().item(), err_msg=key)


def _transformer_pair(tmp_path):
    """A small VQ-VAE teacher and a transformer at dropout 0.1 over it."""
    vq = VQVAETask(**CFG, checkpoint_dir=str(tmp_path), codebook_file=str(tmp_path / "cb.csv"),
                   device="cpu", seed=3)
    task_kw = dict(sample_rate=400, frame_length=2, learning_rate=1e-3,  # T = 800
                   num_layers=2, num_heads=4, hidden_dim=32, dropout=0.1,
                   latent_channels=CFG["embedding_dim"], checkpoint_dir=str(tmp_path),
                   device="cpu")

    return [(TransformerTask(**task_kw, seed=0),
             PortDM(ACC[:1], VAL, quantized_latents=True, quantizer=Quantize(vq)))
            for _ in range(2)]


@pytest.mark.parametrize("model", ["vqvae", "transformer"])
def test_remat_gradients_are_bit_equal(jax_side, tmp_path, model):
    _, params = jax_side
    if model == "vqvae":
        long_batches = _batches(1, 53, t=4000)  # masking on: 21 STFT frames a clip
        pairs = [(_port_task(params, tmp_path / str(i)),
                  PortDM(long_batches, _batches(1, 54, t=4000), masking=True)) for i in range(2)]
    else:
        pairs = _transformer_pair(tmp_path)
    (plain_task, plain_dm), (remat_task, remat_dm) = pairs
    calls = _counted(remat_task)
    want = _one_step(plain_task, plain_dm)
    got = _one_step(remat_task, remat_dm, remat=True)
    assert len(calls) == 2  # the forward, and its recomputation in the backward
    assert got.keys() == want.keys() and got
    for key, g in want.items():
        assert torch.equal(got[key], g), key
    for (key, value), other in zip(plain_task.net.state_dict().items(),
                                   remat_task.net.state_dict().values()):
        assert torch.equal(value, other), key
    # the draws were live: another generator seed gives other gradients
    if model == "transformer":
        other_task, other_dm = _transformer_pair(tmp_path)[0]
        Trainer(max_epochs=1, accelerator="cpu", enable_progress_bar=False, seed=7,
                remat=True).fit(other_task, other_dm)
        assert not torch.equal(other_task.net.fc.weight.grad, want["fc.weight"])


@pytest.mark.parametrize("profiler", ["jax", "simple", "xla", None])
def test_profiler_keyword(jax_side, tmp_path, profiler, caplog):
    _, params = jax_side
    trainer = Trainer(default_root_dir=str(tmp_path), max_epochs=1, limit_train_batches=1,
                      accelerator="cpu", enable_progress_bar=False, profiler=profiler)
    with caplog.at_level("INFO"):
        trainer.fit(_port_task(params, tmp_path / "task"), PortDM(ACC[:1], VAL))
    traces = sorted((tmp_path / "jax_trace").glob("*.pt.trace.json"))
    assert len(traces) == (profiler == "jax")
    assert trainer.profiler.enabled == (profiler == "simple")
    assert ("Profiler report" in caplog.text) == (profiler == "simple")
    if traces:
        events = json.loads(traces[0].read_text())["traceEvents"]
        names = {e.get("name", "") for e in events}
        assert any(n.startswith("aten::conv1d") for n in names), sorted(names)[:20]
        assert any(n.startswith("aten::") and "backward" in n.lower() or "Backward" in n
                   for n in names)
