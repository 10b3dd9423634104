"""Audio-BERT training in the port on the CPU against the JAX package, with a
small BERT (vocab 120, hidden 32, 2 layers, 2 heads), a small VQ-VAE teacher
(hidden 16, K = 16, D = 8) whose codebook the task reads, and frames of
2,200 samples: W = 550 codes, two BERT windows, the second ragged.

* ``Quantize``: code ids bit-equal to JAX's ``get_encodings_idx``, latents
  within 1e-5; the datamodule hands them to the task.
* Masking: JAX's forward with a step key equals the port's forward on the
  ids masked with JAX's uniform draws of that key (``mask_tokens``).
* ``loss_fn`` and ``eval_metrics`` on one mask: losses at atol 1e-6, rtol
  1e-6; SI-SDR at rtol 1e-4, atol 1e-5 (the head's sums in another order).
* The head's gradient within rtol 1e-4, atol 1e-4 of ``jax.grad``'s; BERT and
  the codebook get none.
* 3 ``Trainer.fit`` steps at ``mask_prob=0`` against the JAX Trainer: metrics
  at rtol 1e-3, the head's moves within 0.2·lr where its first-step gradient
  is clear of 0 (optax's AdamW decays p before the step, torch's after:
  rounding apart), BERT and the codebook bit-unchanged.
* A ``fit`` split by ``ckpt_path="last"`` ends where one ``fit`` ends, masking
  on, with one sidecar in the checkpoint directory.
* ``Trainer.predict`` against JAX's, a ragged last batch included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msla_tpu.data.datamodule import SlakhDataModule as JaxSlakhDataModule
from msla_tpu.data.transform import Quantize as JaxQuantize
from msla_tpu.models.bert import AudioBertTask as JaxAudioBertTask
from msla_tpu.models.vqvae import VQVAETask as JaxVQVAETask
from msla_tpu.nn.bert import BertConfig as JaxBertConfig
from msla_tpu.nn.bert import BertForMaskedLM as JaxBertForMaskedLM
from msla_tpu.train.trainer import Trainer as JaxTrainer
from msla_tpu_torch.data.datamodule import SlakhDataModule
from msla_tpu_torch.data.transform import Quantize
from msla_tpu_torch.models.bert import AudioBertTask, mask_tokens
from msla_tpu_torch.models.vqvae import VQVAETask
from msla_tpu_torch.nn.bert import BertConfig
from msla_tpu_torch.train.callbacks import EarlyStopping, ModelCheckpoint
from msla_tpu_torch.train.checkpoint import load_checkpoint
from msla_tpu_torch.train.trainer import Trainer
from msla_tpu_torch.utils.jax_compat import audio_bert_state_dict_from_jax, vqvae_state_dict_from_jax

SMALL = dict(vocab_size=120, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
             intermediate_size=64)
VQ = dict(num_hidden=16, num_residual_layer=2, num_residual_hidden=8, num_embedding=16,
          embedding_dim=8, commitment_cost=0.25, learning_rate=1e-4)
SR, FRAME_S, B = 1100, 2, 2
T = SR * FRAME_S                      # 2,200 samples, W = 550 codes
LR = 2e-4
LOSS_TOL = dict(rtol=1e-6, atol=1e-6)
SDR_TOL = dict(rtol=1e-4, atol=1e-5)
BERT_TOL = dict(rtol=1e-4, atol=1e-5)
DM_ARGS = dict(train_dir="t", val_dir="v", test_dir="s", target_sample_rate=SR,
               target_sample_duration=FRAME_S, max_duration=120, maximum_dataset_size=100,
               batch_size=B)


def _batches(n, seed, b=B):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, 4, T)) * 0.3).astype(np.float32) for _ in range(n)]


TRAIN, VAL = _batches(3, 0), _batches(2, 1)
PREDICT = _batches(2, 2) + _batches(1, 3, b=1)  # the last batch ragged


def _in_memory(cls):
    class InMemory(cls):
        def __init__(self, train=TRAIN, val=VAL, **kw):
            super().__init__(**DM_ARGS, **kw)
            self.train, self.val = train, val

        def train_dataloader(self):
            return list(self.train)

        def val_dataloader(self):
            return list(self.val)

        def predict_dataloader(self):
            return list(PREDICT)

    return InMemory


JaxDM, PortDM = _in_memory(JaxSlakhDataModule), _in_memory(SlakhDataModule)


@pytest.fixture(scope="module")
def side(tmp_path_factory):
    """The JAX teacher and task, their params, and the paths; the codebook CSV
    is the teacher's."""
    root = tmp_path_factory.mktemp("bert_train")
    vq_paths = dict(checkpoint_dir=str(root), codebook_file=str(root / "codebook.csv"))
    jax_vq = JaxVQVAETask(**VQ, sample_rate=SR, **vq_paths)
    mix = np.broadcast_to(TRAIN[0].sum(1, keepdims=True), TRAIN[0].shape)
    vq_params = jax_vq.init_variables(jax.random.PRNGKey(3),
                                      (jnp.asarray(mix), jnp.asarray(TRAIN[0])))["params"]
    codebook = np.asarray(vq_params["vector_quantizer"]["codebook"])
    np.savetxt(vq_paths["codebook_file"], codebook, delimiter=",",
               header=",".join(map(str, range(VQ["embedding_dim"]))), comments="")
    jax_q = JaxQuantize(jax_vq.net, {"params": vq_params})
    jax_task = _jax_task(root)
    batch0 = JaxDM(quantizer=jax_q).on_after_batch_transfer(jnp.asarray(TRAIN[0]))
    params = jax.device_get(jax_task.init_variables(jax.random.PRNGKey(0), batch0)["params"])
    return dict(root=root, vq_params=jax.device_get(vq_params), jax_q=jax_q,
                jax_task=jax_task, params=params)


def _jax_task(root, mask_prob=0.15):
    task = JaxAudioBertTask(LR, str(root / "ckpt"), str(root / "codebook.csv"), SR, FRAME_S,
                            VQ["num_embedding"], mask_prob=mask_prob)
    task.config = JaxBertConfig(**SMALL)
    task.bert = JaxBertForMaskedLM(task.config)
    return task


def _port_task(side, params=None, mask_prob=0.15, **kw):
    task = AudioBertTask(LR, str(side["root"] / "ckpt"), str(side["root"] / "codebook.csv"),
                         SR, FRAME_S, VQ["num_embedding"], mask_prob=mask_prob, device="cpu",
                         config=BertConfig(**SMALL), **kw)
    task.net.load_state_dict(audio_bert_state_dict_from_jax(
        side["params"] if params is None else params))
    return task


def _port_quantize(side):
    vq = VQVAETask(**VQ, sample_rate=SR, checkpoint_dir=str(side["root"]),
                   codebook_file=str(side["root"] / "codebook.csv"), device="cpu")
    vq.net.load_state_dict(vqvae_state_dict_from_jax(side["vq_params"], VQ["num_residual_layer"]))
    return Quantize(vq)


def _ids(side, raw):
    return np.array(side["jax_q"].get_encodings_idx(jnp.asarray(raw)))


def test_quantize_and_the_datamodule_match_jax(side):
    q = _port_quantize(side)
    x = torch.from_numpy(VAL[1])
    ids = q.get_encodings_idx(x)
    assert ids.shape == (B, T // 4)
    np.testing.assert_array_equal(ids.numpy(), _ids(side, VAL[1]))
    latents = q.get_quantized(x)
    np.testing.assert_allclose(latents.numpy(),
                               np.asarray(side["jax_q"].get_quantized(jnp.asarray(VAL[1]))),
                               rtol=1e-5, atol=1e-5)
    got_ids, stems = PortDM(quantizer=q).on_after_batch_transfer(x)
    assert torch.equal(got_ids, ids) and stems is x
    got_latents, _ = PortDM(quantizer=q, quantized_latents=True).on_after_batch_transfer(x)
    assert torch.equal(got_latents, latents)
    assert not latents.requires_grad


def _masked(side, raw, key):
    """(JAX's batch, the port's batch with JAX's draws of ``key`` masked in)."""
    ids = _ids(side, raw)
    uniform = np.array(jax.random.uniform(key, ids.shape))
    masked = mask_tokens(torch.from_numpy(ids).long(), torch.from_numpy(uniform), 0.15)
    assert 0 < (masked == 103).sum() < masked.numel()
    return (jnp.asarray(ids), jnp.asarray(raw)), (masked, torch.from_numpy(raw))


def test_masking_matches_jax_for_the_same_draws(side):
    key = jax.random.PRNGKey(5)
    jax_batch, batch = _masked(side, TRAIN[1], key)
    want = np.asarray(side["jax_task"].forward(side["params"], jax_batch[0], key, train=True))
    got = _port_task(side).forward(batch[0], train=True)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    # the port's own draws: p = 1 masks every id
    task = _port_task(side, mask_prob=1.0)
    every = task.forward(batch[0], torch.Generator().manual_seed(0), train=True)
    torch.testing.assert_close(every, task.forward(torch.full_like(batch[0], 103), train=True),
                               rtol=0, atol=0)


def test_loss_and_metrics_match_jax(side):
    key = jax.random.PRNGKey(6)
    jax_batch, batch = _masked(side, TRAIN[2], key)
    want_loss, want = side["jax_task"].loss_fn(side["params"], jax_batch, key)
    task = _port_task(side)
    loss, got = task.loss_fn(batch, None)
    np.testing.assert_allclose(loss.item(), float(want_loss), **LOSS_TOL)
    assert set(got) == set(want) == {"train/loss"}

    ids = torch.from_numpy(_ids(side, VAL[0]))
    want = side["jax_task"].eval_metrics(side["params"], (jnp.asarray(ids.numpy()),
                                                          jnp.asarray(VAL[0])), "validation")
    with torch.no_grad():
        got = task.eval_metrics((ids, torch.from_numpy(VAL[0])), "validation")
    assert set(got) == set(want) and len(got) == 16
    for k in want:
        tol = SDR_TOL if "si_sdr" in k else LOSS_TOL
        np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=k, **tol)


def test_head_gradient_matches_jax_and_bert_gets_none(side):
    key = jax.random.PRNGKey(7)
    jax_batch, batch = _masked(side, TRAIN[0], key)
    jax_task = side["jax_task"]
    grads = jax.grad(lambda p: jax_task.loss_fn(p, jax_batch, key)[0])(side["params"])
    assert all(not np.asarray(g).any() for g in jax.tree.leaves(grads["bert"]))
    want = audio_bert_state_dict_from_jax(jax.device_get(grads))
    task = _port_task(side)
    task.loss_fn(batch, None)[0].backward()
    for name, p in task.net.named_parameters():
        if name.startswith("head."):
            np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=name)
        else:
            assert not p.requires_grad and p.grad is None, name
    assert not task.net.codebook.requires_grad
    opt = task.configure_optimizer()
    assert [p for g in opt.param_groups for p in g["params"]] == list(task.net.head.parameters())
    assert opt.defaults["weight_decay"] == 0.01 and opt.defaults["betas"] == (0.9, 0.999)


def test_three_fit_steps_match_the_jax_trainer(side, tmp_path):
    jax_task = _jax_task(side["root"], mask_prob=0.0)
    jax_trainer = JaxTrainer(default_root_dir=str(tmp_path), max_epochs=1, accelerator="cpu",
                             enable_progress_bar=False, log_every_n_steps=0, seed=0)
    jax_trainer.fit(jax_task, JaxDM(quantizer=side["jax_q"]))
    end = jax.device_get(jax_trainer.state.params)

    task = _port_task(side, mask_prob=0.0)
    start = {k: v.clone() for k, v in task.net.state_dict().items()}
    trainer = Trainer(max_epochs=1, accelerator="cpu", enable_progress_bar=False,
                      log_every_n_steps=0, seed=0)
    trainer.fit(task, PortDM(quantizer=_port_quantize(side)))
    assert trainer.global_step == jax_trainer.global_step == 3

    want = jax_trainer.callback_metrics
    assert set(trainer.callback_metrics) == set(want) and len(want) == 17
    for k, v in want.items():
        np.testing.assert_allclose(trainer.callback_metrics[k], v, rtol=1e-3, err_msg=k)

    for a, b in zip(jax.tree.leaves(side["params"]["bert"]), jax.tree.leaves(end["bert"])):
        np.testing.assert_array_equal(a, b)
    want_sd = audio_bert_state_dict_from_jax(end)
    ids = _ids(side, TRAIN[0])
    grads = audio_bert_state_dict_from_jax(jax.device_get(jax.grad(
        lambda p: jax_task.loss_fn(p, (jnp.asarray(ids), jnp.asarray(TRAIN[0])),
                                   jax.random.PRNGKey(0))[0])(side["params"])))
    for key, value in task.net.state_dict().items():
        if not key.startswith("head."):  # BERT and the codebook: the same bits
            assert torch.equal(value, start[key]), key
            continue
        g = grads[key].abs()
        sure = g > 1e-3 * g.max()
        moved, want_moved = value - start[key], want_sd[key] - start[key]
        assert want_moved[sure].abs().max() > LR, key
        np.testing.assert_allclose(moved[sure].numpy(), want_moved[sure].numpy(), rtol=0,
                                   atol=0.2 * LR, err_msg=key)


def _fit(side, root, max_epochs, ckpt_path=None):
    task = _port_task(side)
    trainer = Trainer(max_epochs=max_epochs, accelerator="cpu", enable_progress_bar=False,
                      seed=0, callbacks=[ModelCheckpoint(dirpath=str(root), filename="best_bert"),
                                         EarlyStopping(patience=5)])
    trainer.fit(task, PortDM(TRAIN[:2], VAL[:1], quantizer=_port_quantize(side)),
                ckpt_path=ckpt_path)
    return trainer, task


def test_fit_split_by_last_ends_where_one_fit_ends(side, tmp_path):
    whole, task = _fit(side, tmp_path / "whole", 2)
    _fit(side, tmp_path / "split", 1)
    split, resumed = _fit(side, tmp_path / "split", 2, ckpt_path="last")
    assert split.global_step == whole.global_step == 4
    want = task.net.state_dict()
    for key, value in resumed.net.state_dict().items():
        assert torch.equal(value, want[key]), key
    assert split.callback_metrics == whole.callback_metrics
    a, b = whole._optimizer.state_dict(), split._optimizer.state_dict()
    for i, state in a["state"].items():
        for k, v in state.items():
            assert torch.equal(v, b["state"][i][k]), (i, k)
    for d in (tmp_path / "whole", tmp_path / "split"):
        assert len(list(d.glob("frozen-*.ckpt"))) == 1
        for ckpt in d.glob("best_bert*.ckpt"):
            keys = torch.load(ckpt, weights_only=True)["state_dict"]
            assert all(k.startswith("head.") for k in keys), ckpt
    start = audio_bert_state_dict_from_jax(side["params"])
    for key, value in load_checkpoint(tmp_path / "split" / "last.ckpt")["state_dict"].items():
        assert torch.equal(value, want[key]), key
        if not key.startswith("head."):
            assert torch.equal(value, start[key]), key


class _JaxPredictDM(JaxDM):
    def predict_dataloader(self):
        return list(PREDICT)


def test_predict_matches_jax_with_a_ragged_batch(side):
    jax_trainer = JaxTrainer(accelerator="cpu", enable_progress_bar=False, seed=0)
    want = jax_trainer.predict(side["jax_task"], _JaxPredictDM(quantizer=side["jax_q"]))
    task = _port_task(side, params=jax.device_get(jax_trainer.state.params))
    dm = PortDM(quantizer=_port_quantize(side))
    got = Trainer(accelerator="cpu", enable_progress_bar=False).predict(task, dm)
    assert [o.shape[0] for o in got] == [len(p) for p in PREDICT] == [2, 2, 1]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    direct = task.predict_step(dm.on_after_batch_transfer(torch.from_numpy(PREDICT[-1])))
    torch.testing.assert_close(got[-1], direct, rtol=1e-5, atol=1e-6)  # M = 2 against 1
