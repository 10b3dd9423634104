"""msla_tpu_torch.models.bert.AudioBertTask on the CPU against the JAX task on
the same weights (``audio_bert_state_dict_from_jax``), with a small BERT
(vocab 120, hidden 32, 2 layers, 2 heads) and a 16 × 8 codebook:
``predict_step`` stems at rtol = atol = 1e-5 and ``code_proposals`` (ids equal,
confidences at 1e-5) at W = 500 (one 512-token chunk) and W = 1100 (three);
results that do not depend on ``chunk_fold``; and the keywords that wait."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msla_tpu.models.bert import AudioBertTask as JaxAudioBertTask
from msla_tpu.nn.bert import BertConfig as JaxBertConfig
from msla_tpu.nn.bert import BertForMaskedLM as JaxBertForMaskedLM
from msla_tpu_torch.models.bert import AudioBertTask
from msla_tpu_torch.nn.bert import BertConfig
from msla_tpu_torch.utils.jax_compat import audio_bert_state_dict_from_jax

SMALL = dict(vocab_size=120, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
             intermediate_size=64)
K_CODES, DIM, FRAME_S = 16, 8, 2
TOL = dict(rtol=1e-5, atol=1e-5)


def write_codebook(path, k=K_CODES, d=DIM, seed=0):
    cb = np.random.default_rng(seed).standard_normal((k, d)).astype(np.float32)
    np.savetxt(path, cb, delimiter=",", header=",".join(map(str, range(d))), comments="")
    return cb


def make_pair(tmp_path, sr, jax_seed=0, **kw):
    """A JAX task and the port's task on the same weights; W = sr·FRAME_S / 4."""
    cb_path = tmp_path / "codebook.csv"
    if not cb_path.exists():
        write_codebook(cb_path)
    args = (2e-4, str(tmp_path / "ckpt"), str(cb_path), sr, FRAME_S, K_CODES)
    jax_task = JaxAudioBertTask(*args)
    jax_task.config = JaxBertConfig(**SMALL)
    jax_task.bert = JaxBertForMaskedLM(jax_task.config)
    w = sr * FRAME_S // 4
    batch = (jnp.zeros((1, w), jnp.int32), jnp.zeros((1, 4, sr * FRAME_S)))
    params = jax_task.init_variables(jax.random.PRNGKey(jax_seed), batch)["params"]
    # a non-zero vocab bias, so the argmax sees it
    params["bert"] = {**params["bert"], "mlm_bias": jnp.asarray(
        np.random.default_rng(7).standard_normal(SMALL["vocab_size"]), jnp.float32)}
    task = AudioBertTask(*args, device="cpu", config=BertConfig(**SMALL), **kw)
    task.net.load_state_dict(audio_bert_state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return jax_task, params, task


def _indices(b, w, seed=1):
    return np.random.default_rng(seed).integers(0, K_CODES, (b, w)).astype(np.int32)


@pytest.mark.parametrize("sr", [1000, 2200])  # W = 500: one chunk; W = 1100: three
def test_predict_step_matches_jax(tmp_path, sr):
    jax_task, params, task = make_pair(tmp_path, sr)
    idx = _indices(2, sr * FRAME_S // 4)
    stems = np.zeros((2, 4, sr * FRAME_S), np.float32)
    want = np.asarray(jax_task.predict_step(params, (jnp.asarray(idx), jnp.asarray(stems))))
    got = task.predict_step((torch.from_numpy(idx), torch.from_numpy(stems)))
    assert got.shape == (2, 4, sr * FRAME_S) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(task.forward(torch.from_numpy(idx)).numpy(), want, **TOL)


@pytest.mark.parametrize("sr", [1000, 2200])
def test_code_proposals_match_jax(tmp_path, sr):
    jax_task, params, task = make_pair(tmp_path, sr)
    w = sr * FRAME_S // 4
    tokens = _indices(2, w, seed=3)
    tokens[:, ::5] = 103  # [MASK] at every fifth position
    want = np.asarray(jax_task.code_proposals(params, jnp.asarray(tokens)))
    got = task.code_proposals(torch.from_numpy(tokens)).numpy()
    assert got.shape == (2, w, 2)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1], want[..., 1], **TOL)


def test_chunk_fold_does_not_change_the_result(tmp_path):
    """W = 1100 is 3 chunks: fold 1 (three calls), 2 (two calls, the second with
    a whole chunk of padding) and 3 (one call) give the same ids and stems."""
    _, _, ref_task = make_pair(tmp_path, 2200, chunk_fold=1)
    sd = ref_task.net.state_dict()
    idx = torch.from_numpy(_indices(2, 1100, seed=4))
    tokens = idx.clone()
    tokens[:, ::3] = 103
    want_stems = ref_task.forward(idx)
    want_prop = ref_task.code_proposals(tokens)
    for fold in (2, 3):
        _, _, task = make_pair(tmp_path, 2200, chunk_fold=fold)
        task.net.load_state_dict(sd)
        assert task._fold_for(2, 3) == fold
        prop = task.code_proposals(tokens)
        assert torch.equal(prop[..., 0], want_prop[..., 0])
        torch.testing.assert_close(prop[..., 1], want_prop[..., 1], rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(task.forward(idx), want_stems, rtol=1e-6, atol=1e-6)


def test_fold_rule(tmp_path, monkeypatch):
    """Auto fold: one chunk per call on the CPU; on the card all chunks up to
    512 folded sequences (the rule, read without a card)."""
    _, _, task = make_pair(tmp_path, 1000)
    assert task._fold_for(16, 22) == 1
    monkeypatch.setattr(AudioBertTask, "device", property(lambda self: torch.device("cuda")))
    assert task._fold_for(16, 22) == 22   # batch 16: all 22 chunks, 352 sequences
    assert task._fold_for(64, 22) == 8    # batch 64: capped at 512 sequences
    assert task._fold_for(1, 22) == 22


def test_missing_codebook_is_zeros(tmp_path, caplog):
    task = AudioBertTask(2e-4, str(tmp_path), str(tmp_path / "none.csv"), 1000, FRAME_S,
                         K_CODES, device="cpu", config=BertConfig(**SMALL))
    assert "missing" in caplog.text
    assert task.net.codebook.shape == (K_CODES, 64) and not task.net.codebook.any()


def test_head_refuses_a_width_it_was_not_built_for(tmp_path):
    _, _, task = make_pair(tmp_path, 1000)
    with pytest.raises(ValueError, match="sample_rate·frame_length / 8"):
        task.forward(torch.from_numpy(_indices(1, 600)))


def test_keywords_that_wait_raise(tmp_path):
    write_codebook(tmp_path / "codebook.csv")
    args = (2e-4, str(tmp_path), str(tmp_path / "codebook.csv"), 1000, FRAME_S, K_CODES)
    kw = dict(device="cpu", config=BertConfig(**SMALL))
    for bad, match in ((dict(use_pallas=False), "ROADMAP.md §3"),
                       (dict(use_flash=False), "ROADMAP.md §3"),
                       (dict(pretrained_weights=str(tmp_path / "codebook.csv")),
                        "queue item 8")):
        with pytest.raises(NotImplementedError, match=match):
            AudioBertTask(*args, **bad, **kw)
    # bf16 serves now (tests/test_torch_bf16_bert.py holds it against JAX)
    assert AudioBertTask(*args, compute_dtype="bfloat16", **kw).bert.dtype == torch.bfloat16
    task = AudioBertTask(*args, pretrained_weights=str(tmp_path / "absent.msgpack"), **kw)
    idx = torch.zeros((1, 500), dtype=torch.int64)
    batch = (idx, torch.zeros((1, 4, 2000)))
    for call in (lambda: task.forward(idx, train=True), lambda: task.loss_fn(batch),
                 lambda: task.eval_metrics(batch, "validation"),
                 task.configure_optimizer):
        with pytest.raises(NotImplementedError, match="queue item 5"):
            call()
