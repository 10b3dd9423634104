"""JAX params → the port's state_dicts (VQ-VAE, BERT, Audio-BERT).

The port keeps the reference torch models' key names (HF's for BERT). Weight
layouts:

* flax Conv kernel (k, in, out)                              → Conv1d (out, in, k)
* flax ConvTranspose (transpose_kernel=True) kernel (k, out, in) → ConvTranspose1d (in, out, k)
* flax Dense kernel (in, out)                                → Linear (out, in)
* flax LayerNorm ``scale``                                   → LayerNorm ``weight``

Reversing the axes is the map for all three kernels. The params come in as a
nested dict of arrays (numpy, or anything ``np.asarray`` takes); nothing of
JAX is needed.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _leaf(tree: Mapping[str, Any], *path: str) -> torch.Tensor:
    for key in path:
        tree = tree[key]
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def _conv(sd: dict, key: str, p: Mapping[str, Any]) -> None:
    sd[f"{key}.weight"] = _leaf(p, "conv", "kernel").permute(2, 1, 0).contiguous()
    if "bias" in p["conv"]:
        sd[f"{key}.bias"] = _leaf(p, "conv", "bias")


def _residual_stack(sd: dict, prefix: str, p: Mapping[str, Any], num_layers: int) -> None:
    for i in range(num_layers):
        # reference Sequential: [ReLU, Conv k3, ReLU, Conv k1] → indices 1 and 3
        _conv(sd, f"{prefix}.residual_layers.{i}.1", p[f"block{i}_conv3"])
        _conv(sd, f"{prefix}.residual_layers.{i}.3", p[f"block{i}_conv1"])


def vqvae_state_dict_from_jax(params: Mapping[str, Any],
                              num_residual_layer: int) -> dict[str, torch.Tensor]:
    """JAX ``VQVAENet`` params → ``msla_tpu_torch.nn.VQVAENet`` state_dict (CPU)."""
    sd: dict[str, torch.Tensor] = {}
    enc = params["encoder"]
    for k in ("conv1", "conv2", "conv3"):
        _conv(sd, f"encoder.{k}", enc[k])
    _residual_stack(sd, "encoder.residual_stack", enc["residual_stack"], num_residual_layer)
    _conv(sd, "conv", params["pre_vq_conv"])
    sd["vector_quantizer.codebook.weight"] = _leaf(params, "vector_quantizer", "codebook")
    dec = params["decoder"]
    _conv(sd, "decoder.conv1", dec["conv1"])
    _residual_stack(sd, "decoder.residual_stack", dec["residual_stack"], num_residual_layer)
    for k in ("conv1_transpose", "conv2_transpose"):
        _conv(sd, f"decoder.{k}", dec[k])
    return sd


def _dense(sd: dict, key: str, p: Mapping[str, Any]) -> None:
    sd[f"{key}.weight"] = _leaf(p, "kernel").T.contiguous()
    sd[f"{key}.bias"] = _leaf(p, "bias")


def _layer_norm(sd: dict, key: str, p: Mapping[str, Any]) -> None:
    sd[f"{key}.weight"] = _leaf(p, "scale")
    sd[f"{key}.bias"] = _leaf(p, "bias")


def bert_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``BertForMaskedLM`` params → ``msla_tpu_torch.nn.bert.BertForMaskedLM``
    state_dict (CPU), in HF's key names, the tied decoder's included."""
    sd: dict[str, torch.Tensor] = {}
    emb = params["embeddings"]
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        sd[f"bert.embeddings.{name}.weight"] = _leaf(emb, name, "embedding")
    _layer_norm(sd, "bert.embeddings.LayerNorm", emb["layer_norm"])
    n_layers = sum(1 for k in params if k.startswith("layer"))
    for i in range(n_layers):
        p, key = params[f"layer{i}"], f"bert.encoder.layer.{i}"
        att = p["attention"]
        for jax_name, hf_name in (("q_proj", "query"), ("k_proj", "key"), ("v_proj", "value")):
            _dense(sd, f"{key}.attention.self.{hf_name}", att[jax_name])
        _dense(sd, f"{key}.attention.output.dense", att["out_proj"])
        _layer_norm(sd, f"{key}.attention.output.LayerNorm", p["attention_norm"])
        _dense(sd, f"{key}.intermediate.dense", p["intermediate"])
        _dense(sd, f"{key}.output.dense", p["output"])
        _layer_norm(sd, f"{key}.output.LayerNorm", p["output_norm"])
    _dense(sd, "cls.predictions.transform.dense", params["mlm_transform"])
    _layer_norm(sd, "cls.predictions.transform.LayerNorm", params["mlm_norm"])
    sd["cls.predictions.bias"] = _leaf(params, "mlm_bias")
    sd["cls.predictions.decoder.weight"] = sd["bert.embeddings.word_embeddings.weight"]
    sd["cls.predictions.decoder.bias"] = sd["cls.predictions.bias"]
    return sd


def audio_bert_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``AudioBertTask`` params ``{"bert", "head", "codebook"}`` →
    ``AudioBertTask.net`` state_dict (CPU)."""
    sd = {f"bert.{k}": v for k, v in bert_state_dict_from_jax(params["bert"]).items()}
    _conv(sd, "head.conv", params["head"]["conv"])
    _dense(sd, "head.linear", params["head"]["linear"]["dense"])
    sd["codebook"] = _leaf(params, "codebook")
    return sd
