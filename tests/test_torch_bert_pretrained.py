"""The pretrained-weights loader of ``AudioBertTask`` (``pretrained_weights``)
on the CPU against the JAX package, with a small BERT (vocab 120, hidden 32,
2 layers, 2 heads): a flax BERT written as ``tools/convert_hf_bert.py`` writes
it (``msgpack_serialize``), read by the port's own decoder, and an HF
``BertForMaskedLM`` state_dict saved with ``torch.save``, give MLM hidden
states equal to JAX's (the JAX task's own load, and the JAX package's
``bert_params_from_hf``) at the BERT tests' rtol 1e-4, atol 1e-5; the load is
strict (a missing or resized key raises); a file of neither format raises; an
absent path warns and keeps the random init."""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from msla_tpu.models.bert import AudioBertTask as JaxAudioBertTask
from msla_tpu.nn.bert import BertConfig as JaxBertConfig
from msla_tpu.nn.bert import BertForMaskedLM as JaxBertForMaskedLM
from msla_tpu.utils.torch_compat import bert_params_from_hf
from msla_tpu_torch.models.bert import AudioBertTask
from msla_tpu_torch.nn.bert import BertConfig
from test_torch_audio_bert import K_CODES, SMALL, write_codebook

BERT_TOL = dict(rtol=1e-4, atol=1e-5)
SR, FRAME_S, LR = 1000, 2, 2e-4


@pytest.fixture
def args(tmp_path):
    write_codebook(tmp_path / "codebook.csv")
    return (LR, str(tmp_path), str(tmp_path / "codebook.csv"), SR, FRAME_S, K_CODES)


KW = dict(device="cpu", config=BertConfig(**SMALL))


def _hidden_of(task, tokens):
    with torch.no_grad():
        return task.bert(torch.from_numpy(tokens), return_mlm_hidden=True).numpy()


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(8).integers(0, SMALL["vocab_size"], (2, 40))


def test_pretrained_msgpack_weights(args, tmp_path, tokens):
    """A flax BERT as tools/convert_hf_bert.py writes it (msgpack_serialize)."""
    jax_net = JaxBertForMaskedLM(JaxBertConfig(**SMALL))
    params = jax_net.init(jax.random.PRNGKey(11), jnp.zeros((1, 8), jnp.int32))["params"]
    params = {**params, "mlm_bias": jnp.asarray(
        np.random.default_rng(12).standard_normal(SMALL["vocab_size"]), jnp.float32)}
    path = tmp_path / "bert-base-uncased.msgpack"
    path.write_bytes(serialization.msgpack_serialize(params))
    task = AudioBertTask(*args, pretrained_weights=str(path), **KW)
    want = np.asarray(jax_net.apply({"params": params}, jnp.asarray(tokens),
                                    return_mlm_hidden=True))
    np.testing.assert_allclose(_hidden_of(task, tokens), want, **BERT_TOL)
    # the JAX task reads the same file into the same weights
    jax_task = JaxAudioBertTask(*args, pretrained_weights=str(path))
    loaded = jax_task._maybe_load_pretrained(jax.tree.map(jnp.zeros_like, params))
    np.testing.assert_array_equal(np.asarray(loaded["layer1"]["output"]["kernel"]),
                                  np.asarray(params["layer1"]["output"]["kernel"]))

    bad = dict(params)
    del bad["mlm_norm"]
    path.write_bytes(serialization.msgpack_serialize(bad))
    with pytest.raises(KeyError, match="mlm_norm"):
        AudioBertTask(*args, pretrained_weights=str(path), **KW)


def test_pretrained_hf_state_dict(args, tmp_path, tokens, caplog):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(13)
    hf = transformers.BertForMaskedLM(transformers.BertConfig(**SMALL))
    sd = hf.state_dict()
    path = tmp_path / "hf.pt"
    torch.save(sd, path)
    task = AudioBertTask(*args, pretrained_weights=str(path), **KW)
    params = bert_params_from_hf({k: v.numpy() for k, v in sd.items()},
                                 num_layers=SMALL["num_hidden_layers"])
    want = np.asarray(JaxBertForMaskedLM(JaxBertConfig(**SMALL)).apply(
        {"params": params}, jnp.asarray(tokens), return_mlm_hidden=True))
    np.testing.assert_allclose(_hidden_of(task, tokens), want, **BERT_TOL)

    for broken, match in (({k: v for k, v in sd.items() if "encoder.layer.1." not in k},
                           "Missing key"),
                          ({**sd, "cls.predictions.bias": torch.zeros(7)}, "size mismatch")):
        torch.save(broken, path)
        with pytest.raises(RuntimeError, match=match):
            AudioBertTask(*args, pretrained_weights=str(path), **KW)
    (tmp_path / "notes.txt").write_text("not weights")
    with pytest.raises(ValueError, match="neither"):
        AudioBertTask(*args, pretrained_weights=str(tmp_path / "notes.txt"), **KW)

    with caplog.at_level(logging.WARNING):
        absent = AudioBertTask(*args, pretrained_weights=str(tmp_path / "absent.msgpack"), **KW)
    assert "not found" in caplog.text
    fresh = AudioBertTask(*args, **KW)
    for (k, v), w in zip(absent.net.state_dict().items(), fresh.net.state_dict().values()):
        assert torch.equal(v, w), k
