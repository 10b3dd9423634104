"""The ``wire`` checkpoint codecs of the port against the JAX package's, on the CPU.

* ``parse_wire`` gives the JAX ``_parse_wire``'s codecs and raises its
  ``ValueError``s.
* q8 and bf16: the port's encode is bit-equal to ``_q8_encode_jnp`` and to
  jnp's bf16 cast (ties at half a step included), its decode to the JAX
  ``_wire_decode_leaf``; each decoded value lies within bf16's rounding or
  half a q8 step of its block's max of the exact one.
* A JAX file saved with ``wire="q8"`` or "bf16" (weights, optax's Adam, a
  small leaf and a bf16 leaf, which stay as they are) loads bit-equal to the
  JAX ``load_checkpoint``.
* The Trainer: ``ModelCheckpoint(wire="q8")`` writes ``last.ckpt`` wired and
  the best files exact, as the JAX callback; ``MSLA_CKPT_WIRE`` wires a
  ``save_checkpoint`` that names no wire and leaves the best files exact;
  the frozen sidecar stays exact; ``fit`` resumes from the q8 ``last.ckpt``
  on its decoded weights and moments.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from msla_tpu.train import checkpoint as jax_ckpt
from msla_tpu_torch.models.vqvae import VQVAETask
from msla_tpu_torch.train import checkpoint
from msla_tpu_torch.train.callbacks import ModelCheckpoint
from msla_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from msla_tpu_torch.train.trainer import Trainer
from test_torch_train import PortDM, _batches

#: the full-width VQ-VAE, whose stems' and codebook's tensors pass the 16,384 floor
WIDE = dict(num_hidden=128, num_residual_layer=2, num_residual_hidden=32, num_embedding=512,
            embedding_dim=64, commitment_cost=0.25, learning_rate=1e-4, sample_rate=1000)
TRAIN, VAL = _batches(2, 40), _batches(1, 41)


@pytest.mark.parametrize("spec", [None, "", "bf16", "bfloat16", "q8", "off", "exact", " q8 ",
                                  "params=q8,opt=off", "opt=bf16", "params=off,opt=q8",
                                  "fp8", "params=q4", "weights=bf16", "params=bf16,opt"])
def test_parse_wire_is_jax(spec):
    try:
        want = jax_ckpt._parse_wire(spec)
    except ValueError as err:
        with pytest.raises(ValueError) as ours:
            checkpoint.parse_wire(spec)
        assert str(ours.value) == str(err)
        return
    assert checkpoint.parse_wire(spec) == want


def _tensors(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(17 * 1024 + 517).astype(np.float32)
    x[:1024] = 0.0                                   # an all-zero block: scale 0
    x[1024:1030] = [127.0, 63.5, -0.5, 0.5, 1.5, -2.5]  # ties at half a step
    return [x.reshape(75, 239),
            (rng.standard_normal((180, 128)) * 1e-3).astype(np.float32),
            (rng.standard_normal((257, 100)) * 1e30).astype(np.float32)]


@pytest.mark.parametrize("i", [0, 1, 2])
def test_q8_and_bf16_are_the_jax_codecs(i):
    x = _tensors()[i]
    q, s = checkpoint.q8_encode(torch.from_numpy(x))
    want_q, want_s = jax_ckpt._q8_encode_jnp(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))
    assert q.dtype == torch.int8 and s.dtype == torch.float32

    t = torch.from_numpy(x)
    for codec in ("q8", "bf16"):
        node = checkpoint.wire_encode({"w": t}, codec)["w"]
        assert node["__wire__"] == codec and node["dtype"] == "float32"
        got = checkpoint.wire_decode({"w": node})["w"]
        jax_node = {"__wire__": codec, "dtype": "float32", "shape": np.asarray(x.shape)}
        if codec == "bf16":
            np.testing.assert_array_equal(node["v"].float().numpy(),
                                          np.asarray(jnp.asarray(x).astype(jnp.bfloat16),
                                                     dtype=np.float32))
            jax_node["v"] = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
            bound = np.abs(x) * 2.0 ** -8  # bf16 rounds to nearest: half an ulp
        else:
            jax_node.update(q=np.asarray(want_q), s=np.asarray(want_s))
            flat = np.pad(np.abs(x).ravel(), (0, (-x.size) % 1024)).reshape(-1, 1024)
            # half a step of the block's max, and fp32's rounding of the scale and product
            bound = np.repeat(flat.max(1) * (0.5 / 127 + 2.0 ** -22), 1024)[:x.size].reshape(
                x.shape)
        np.testing.assert_array_equal(got.numpy(), jax_ckpt._wire_decode_leaf(jax_node))
        assert got.shape == t.shape and got.dtype == t.dtype
        assert (np.abs(got.numpy() - x) <= bound).all(), codec


def _jax_tree():
    rng = np.random.default_rng(3)
    return {"enc": {"kernel": jnp.asarray(rng.standard_normal((4, 64, 128)), jnp.float32),
                    "bias": jnp.asarray(rng.standard_normal(128), jnp.float32)},
            "codebook": jnp.asarray(rng.standard_normal((512, 64)), jnp.float32),
            "half": jnp.asarray(rng.standard_normal((200, 100)), jnp.bfloat16)}


@pytest.mark.parametrize("wire", ["q8", "bf16", "params=q8,opt=bf16"])
def test_a_wired_jax_file_loads_as_jax_loads_it(tmp_path, wire):
    params = _jax_tree()
    tx = optax.adam(1e-3)
    opt_state = tx.init(params)
    grads = jax.tree.map(lambda p: jnp.ones_like(p) * 0.1, params)
    _, opt_state = tx.update(grads, opt_state, params)
    path = tmp_path / "jax.ckpt"
    jax_ckpt.save_checkpoint(path, params=params, opt_state=opt_state, epoch=1, global_step=1,
                             wire=wire)
    want = jax_ckpt.load_checkpoint(path)
    got = load_checkpoint(path)
    assert got["format"] == "jax" and "wire" not in got
    flat_want = jax.tree_util.tree_leaves_with_path({"s": want["state_dict"],
                                                     "o": want["opt_state"]})
    flat_got = dict(jax.tree_util.tree_leaves_with_path({"s": got["state_dict"],
                                                         "o": got["opt_state"]}))
    assert len(flat_want) == len(flat_got) == 13  # 4 weights, mu, nu and the count
    for key, value in flat_want:
        value = np.asarray(value)
        mine = flat_got[key]
        mine = mine.view(torch.uint16).numpy().view(ml_dtypes.bfloat16) if (
            isinstance(mine, torch.Tensor) and mine.dtype == torch.bfloat16) else np.asarray(mine)
        assert mine.dtype == value.dtype and mine.shape == value.shape, key
        np.testing.assert_array_equal(mine, value, err_msg=str(key))
    assert float(got["state_dict"]["enc"]["bias"][0]) == float(params["enc"]["bias"][0])


def _task(tmp_path, seed=0):
    return VQVAETask(**WIDE, checkpoint_dir=str(tmp_path), codebook_file=str(tmp_path / "cb.csv"),
                     device="cpu", seed=seed)


def _fit(tmp_path, ckpt_dir, max_epochs=1, ckpt_path=None, **cb):
    task = _task(tmp_path)
    trainer = Trainer(max_epochs=max_epochs, accelerator="cpu", enable_progress_bar=False,
                      seed=0, callbacks=[ModelCheckpoint(dirpath=str(ckpt_dir), **cb)])
    trainer.fit(task, PortDM(TRAIN, VAL), ckpt_path=ckpt_path)
    return trainer, task


def _wired(node) -> list[str]:
    """The codecs of a raw file's encoded tensors."""
    if isinstance(node, dict):
        if "__wire__" in node:
            return [node["__wire__"]]
        return [c for v in node.values() for c in _wired(v)]
    return []


def test_model_checkpoint_wires_last_and_fit_resumes_from_it(tmp_path):
    trainer, task = _fit(tmp_path, tmp_path / "ckpt", wire="q8")
    raw = torch.load(tmp_path / "ckpt" / "last.ckpt", weights_only=True)
    assert raw["wire"] == "q8"
    assert set(_wired(raw["state_dict"])) == {"bf16"} and set(_wired(raw["opt_state"])) == {"q8"}
    assert "encoder.conv2.weight" in [k for k, v in raw["state_dict"].items()
                                      if isinstance(v, dict)]
    assert torch.equal(raw["state_dict"]["encoder.conv2.bias"],
                       task.net.state_dict()["encoder.conv2.bias"])  # 128 elements: exact
    for best in ("best.ckpt", "best-v0.ckpt"):
        exact = torch.load(tmp_path / "ckpt" / best, weights_only=True)
        assert "wire" not in exact and not _wired(exact["state_dict"]) + _wired(
            exact["opt_state"])
    exact_bytes = (tmp_path / "ckpt" / "best.ckpt").stat().st_size
    # a third for the wired tensors; the residual stacks' (under 16,384 each) stay fp32
    assert (tmp_path / "ckpt" / "last.ckpt").stat().st_size < 0.6 * exact_bytes

    decoded = load_checkpoint(tmp_path / "ckpt" / "last.ckpt")
    sd = task.net.state_dict()
    for key, value in decoded["state_dict"].items():
        assert value.dtype == sd[key].dtype and value.shape == sd[key].shape
        assert (value - sd[key]).abs().max() <= sd[key].abs().max() * 2.0 ** -8, key

    # fit from the wired file: its decoded weights and moments, then one step on
    resumed = Trainer(max_epochs=2, accelerator="cpu", enable_progress_bar=False, seed=0)
    task2 = _task(tmp_path, seed=1)
    resumed._setup(task2, PortDM(TRAIN, VAL))
    resumed._restore(tmp_path / "ckpt" / "last.ckpt")
    for key, value in task2.net.state_dict().items():
        assert torch.equal(value, decoded["state_dict"][key]), key
    moments = resumed._optimizer.state_dict()["state"]
    for i, state in decoded["opt_state"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(moments[i][k], state[k]), (i, k)
    resumed.fit(task2, PortDM(TRAIN, VAL), ckpt_path=str(tmp_path / "ckpt" / "last.ckpt"))
    assert (resumed.global_step, resumed.current_epoch) == (4, 2)


def test_msla_ckpt_wire_is_honoured_and_best_stays_exact(tmp_path, monkeypatch):
    monkeypatch.setenv("MSLA_CKPT_WIRE", "bf16")
    trainer, task = _fit(tmp_path, tmp_path / "ckpt")
    last = torch.load(tmp_path / "ckpt" / "last.ckpt", weights_only=True)
    assert last["wire"] == "bf16" and set(_wired(last["state_dict"])) == {"bf16"}
    best = torch.load(tmp_path / "ckpt" / "best.ckpt", weights_only=True)
    assert "wire" not in best and not _wired(best["state_dict"])
    save_checkpoint(tmp_path / "plain.ckpt", state_dict=task.net.state_dict())
    assert torch.load(tmp_path / "plain.ckpt", weights_only=True)["wire"] == "bf16"
    save_checkpoint(tmp_path / "pinned.ckpt", state_dict=task.net.state_dict(), wire="off")
    assert "wire" not in torch.load(tmp_path / "pinned.ckpt", weights_only=True)
    with pytest.raises(ValueError, match="unknown checkpoint wire spec"):
        save_checkpoint(tmp_path / "bad.ckpt", state_dict=task.net.state_dict(), wire="q4")


def test_the_frozen_sidecar_stays_exact(tmp_path):
    rng = torch.Generator().manual_seed(0)
    sd = {"bert.w": torch.randn(200, 100, generator=rng), "head.w": torch.randn(200, 100,
                                                                              generator=rng)}
    save_checkpoint(tmp_path / "a.ckpt", state_dict=sd, frozen_keys=("bert",), wire="bf16")
    raw = torch.load(tmp_path / "a.ckpt", weights_only=True)
    side = torch.load(tmp_path / raw["frozen_file"], weights_only=True)["state_dict"]
    assert torch.equal(side["bert.w"], sd["bert.w"])
    assert _wired(raw["state_dict"]) == ["bf16"]
    loaded = load_checkpoint(tmp_path / "a.ckpt")["state_dict"]
    assert torch.equal(loaded["bert.w"], sd["bert.w"])
    assert torch.equal(loaded["head.w"], sd["head.w"].to(torch.bfloat16).float())
