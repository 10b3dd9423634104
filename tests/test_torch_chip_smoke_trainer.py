"""chip_smoke.py's phase-25 helpers on the CPU, against the packages they stand in for.

* ``read_events`` (its own bitwise CRC-32C and protobuf reader) reads the
  port's event files and tensorboardX's alike: the same scalars, steps and
  text; a flipped bit fails it.
* ``msgpack_pack`` writes flax's ``msgpack_serialize`` bytes for a
  checkpoint-shaped tree; ``vqvae_jax_tree`` is the inverse of
  ``vqvae_state_dict_from_jax`` and lays the params out as the JAX
  ``VQVAENet``'s; a file of ``jax_checkpoint``'s payload reads, through the
  port's ``load_checkpoint``, as the JAX ``load_checkpoint`` reads it.
* ``wire_error_ok`` holds the port's decoded bf16 and q8 tensors and rejects
  an error past the bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import chip_smoke
from msla_tpu.models.vqvae import VQVAETask as JaxVQVAETask
from msla_tpu.train import loggers as jax_loggers
from msla_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from msla_tpu_torch.models.vqvae import VQVAETask
from msla_tpu_torch.train import loggers
from msla_tpu_torch.train.checkpoint import load_checkpoint, wire_decode, wire_encode
from msla_tpu_torch.utils.jax_compat import vqvae_state_dict_from_jax

CALLS = [({"train/loss": 1.5, "train/perplexity": 3.0}, 1),
         ({"validation/loss": float("nan"), "x": -0.25}, 2)]


@pytest.mark.parametrize("module", [loggers, jax_loggers], ids=["port", "tensorboardX"])
def test_read_events_reads_both_writers(tmp_path, module):
    lg = module.TensorBoardLogger(str(tmp_path))
    lg.log_hyperparams({"num_embedding": 512})
    for metrics, step in CALLS:
        lg.log_metrics(metrics, step)
    lg.finalize()
    path, = tmp_path.glob("events.out.tfevents.*")
    events = chip_smoke.read_events(path)
    assert events[0]["file_version"] == "brain.Event:2"
    assert events[1]["texts"][0][:2] == ("hparams/text_summary", "text")
    assert '"num_embedding": 512' in events[1]["texts"][0][2]
    scalars = [(tag, e["step"], v) for e in events for tag, v in e["scalars"]]
    want = [(k, step, v) for metrics, step in CALLS for k, v in metrics.items()]
    assert [s[:2] for s in scalars] == [w[:2] for w in want]
    np.testing.assert_array_equal([s[2] for s in scalars], [w[2] for w in want])
    data = bytearray(path.read_bytes())
    data[-6] ^= 0x10
    path.write_bytes(bytes(data))
    with pytest.raises(RuntimeError, match="fails its CRC"):
        chip_smoke.read_events(path)


def test_msgpack_pack_writes_flax_bytes():
    rng = np.random.default_rng(0)
    tree = {"state_dict": {"a": {"kernel": rng.standard_normal((3, 2, 5)).astype(np.float32),
                                 "bias": np.zeros(0, np.float32)},
                           "b": rng.integers(-5, 5, (70000,)).astype(np.int32)},
            "opt_state": {"0": {"count": np.array(7, np.int32),
                                "mu": {"x": np.ones((1,), np.float32)}}, "1": {}},
            "epoch": 3, "global_step": 300, "big": 2**40, "neg": -200, "tiny": -3,
            "hparams": "x" * 40, "long": "é" * 300, "callback_metrics": {"v": 0.5},
            "callbacks": "[]", "bytes": b"\x00\x01" * 200, "flag": True, "none": None,
            "list": [1, "a", 2.5] * 7}
    assert chip_smoke.msgpack_pack(tree) == serialization.msgpack_serialize(tree)


@pytest.fixture(scope="module")
def jax_vqvae(tmp_path_factory):
    root = tmp_path_factory.mktemp("vq")
    cfg = dict(num_hidden=16, num_residual_layer=2, num_residual_hidden=8, num_embedding=16,
               embedding_dim=8, commitment_cost=0.25, learning_rate=1e-4, sample_rate=1000)
    task = JaxVQVAETask(**cfg, checkpoint_dir=str(root), codebook_file=str(root / "cb.csv"))
    x = jnp.asarray(np.random.default_rng(1).standard_normal((1, 4, 800)), jnp.float32)
    params = jax.device_get(task.init_variables(jax.random.PRNGKey(0), (x, x))["params"])
    return cfg, params, root


def test_the_jax_layout_inverts_jax_compat(jax_vqvae, tmp_path):
    cfg, params, _ = jax_vqvae
    sd = vqvae_state_dict_from_jax(params, 2)
    tree = chip_smoke.vqvae_jax_tree(sd, 2)
    assert jax.tree.structure(tree) == jax.tree.structure(params)
    for got, want in zip(jax.tree.leaves(tree), jax.tree.leaves(params)):
        np.testing.assert_array_equal(got, want)

    # a stepped port Trainer's state as a JAX file: the JAX package reads it
    task = VQVAETask(**cfg, checkpoint_dir=str(tmp_path), codebook_file=str(tmp_path / "c.csv"),
                     device="cpu")
    opt = task.configure_optimizer()
    task.loss_fn((torch.randn(2, 4, 800), torch.randn(2, 4, 800)))[0].backward()
    opt.step()

    class Stepped:
        _optimizer, current_epoch, global_step = opt, 1, 1

    payload = chip_smoke.jax_checkpoint(Stepped, task)
    path = tmp_path / "jax.ckpt"
    path.write_bytes(chip_smoke.msgpack_pack(payload))
    theirs = jax_load_checkpoint(path)
    ours = load_checkpoint(path)
    assert ours["format"] == "jax" and ours["global_step"] == theirs["global_step"] == 1
    assert int(theirs["opt_state"]["0"]["count"]) == 1
    want = task.state_dict_from_jax(theirs["state_dict"])
    for k, v in task.net.state_dict().items():
        assert torch.equal(want[k], v), k
    names = {id(p): n for n, p in task.net.named_parameters()}
    mu = task.state_dict_from_jax(theirs["opt_state"]["0"]["mu"])
    for p, s in opt.state.items():
        assert torch.equal(mu[names[id(p)]], s["exp_avg"])


@pytest.mark.parametrize("codec", ["bf16", "q8"])
def test_wire_error_ok_holds_the_codecs(codec):
    x = torch.randn(40, 1000, generator=torch.Generator().manual_seed(2))
    x[3, :500] *= 1e-4
    got = wire_decode(wire_encode({"x": x}, codec))["x"]
    assert chip_smoke.wire_error_ok(codec, x, got)
    worse = got.clone()
    worse[3, 7] += 2 * (x[3, 7].abs() * 2.0 ** -8 + x.abs().max() / 127)
    assert not chip_smoke.wire_error_ok(codec, x, worse)
    small = torch.randn(100)
    assert chip_smoke.wire_error_ok(codec, small, small.clone())
    assert not chip_smoke.wire_error_ok(codec, small, small.to(torch.bfloat16).float())
