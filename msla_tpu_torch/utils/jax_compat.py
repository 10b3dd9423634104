"""JAX params → the port's state_dicts (VQ-VAE, BERT, Audio-BERT, the
transformer), and optax's Adam state → torch's (``adam_state_from_jax``).

The port keeps the reference torch models' key names (HF's for BERT), and
the flax tree's for the transformer, whose ``zero_memory`` cross-attention
the reference's packed ``in_proj`` names cannot hold. Weight layouts:

* flax Conv kernel (k, in, out)                              → Conv1d (out, in, k)
* flax ConvTranspose (transpose_kernel=True) kernel (k, out, in) → ConvTranspose1d (in, out, k)
* flax Dense kernel (in, out)                                → Linear (out, in)
* flax LayerNorm ``scale``                                   → LayerNorm ``weight``

Reversing the axes is the map for all three kernels. The params come in as a
nested dict of arrays (numpy, anything ``np.asarray`` takes, or the
``torch.bfloat16`` tensors ``utils/msgpack.py`` gives for bf16 leaves);
nothing of JAX is needed. Every tensor comes out fp32, as the port's
parameters are.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _leaf(tree: Mapping[str, Any], *path: str) -> torch.Tensor:
    for key in path:
        tree = tree[key]
    if isinstance(tree, torch.Tensor):
        return tree.to(torch.float32, copy=True)
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


def audio_bert_head_state_dict_from_jax(head: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX ``AudioBertTask``'s ``head`` subtree → ``head.*`` of its net."""
    sd: dict[str, torch.Tensor] = {}
    _conv(sd, "head.conv", head["conv"])
    _dense(sd, "head.linear", head["linear"]["dense"])
    return sd


def audio_bert_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``AudioBertTask`` params ``{"bert", "head", "codebook"}`` →
    ``AudioBertTask.net`` state_dict (CPU)."""
    sd = {f"bert.{k}": v for k, v in bert_state_dict_from_jax(params["bert"]).items()}
    sd.update(audio_bert_head_state_dict_from_jax(params["head"]))
    sd["codebook"] = _leaf(params, "codebook")
    return sd


def adam_state_from_jax(optimizer: torch.optim.Optimizer, net: torch.nn.Module,
                        adam: Mapping[str, Any], to_port) -> dict:
    """optax's ``ScaleByAdamState`` as flax's ``to_state_dict`` stores it
    (``count``, ``mu`` and ``nu`` trees shaped as the params) → the state_dict
    of torch's ``Adam``/``AdamW`` over ``net``'s parameters: each parameter's
    ``step`` (the count), ``exp_avg`` (mu) and ``exp_avg_sq`` (nu). ``to_port``
    maps a tree of the params' shape to ``net``'s names and layouts (the
    conv kernels' transposes and the like), as it maps the params; it sees
    the moment trees, so it covers the optimized parameters only. The
    optimizer's own ``param_groups`` are kept."""
    mu, nu = to_port(adam["mu"]), to_port(adam["nu"])
    step = float(np.asarray(adam["count"]))
    names = {id(p): n for n, p in net.named_parameters()}
    current = optimizer.state_dict()
    state = {}
    for group, saved in zip(optimizer.param_groups, current["param_groups"]):
        for p, index in zip(group["params"], saved["params"]):
            name = names[id(p)]
            state[index] = {"step": torch.tensor(step), "exp_avg": mu[name],
                            "exp_avg_sq": nu[name]}
    return {"state": state, "param_groups": current["param_groups"]}


def transformer_state_dict_from_jax(params: Mapping[str, Any],
                                    num_layers: int) -> dict[str, torch.Tensor]:
    """JAX ``TransformerQuantizerNet`` params →
    ``msla_tpu_torch.nn.transformer_net.TransformerQuantizerNet`` state_dict
    (CPU). The port's names are the flax tree's: ``embedding``, ``fc`` and
    ``layer{i}`` with ``self_attn``, ``cross_attn_out_bias`` (or
    ``cross_attn``), ``norm1``..``norm3`` and ``linear1``/``linear2`` or
    ``moe``, whose stacked expert tensors keep their layout."""
    sd: dict[str, torch.Tensor] = {}
    _dense(sd, "embedding", params["embedding"])
    _dense(sd, "fc", params["fc"])
    for i in range(num_layers):
        p, key = params[f"layer{i}"], f"layer{i}"
        for attn in ("self_attn", "cross_attn"):
            if attn in p:
                for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    _dense(sd, f"{key}.{attn}.{proj}", p[attn][proj])
        if "cross_attn_out_bias" in p:
            sd[f"{key}.cross_attn_out_bias"] = _leaf(p, "cross_attn_out_bias")
        for norm in ("norm1", "norm2", "norm3"):
            _layer_norm(sd, f"{key}.{norm}", p[norm])
        if "moe" in p:
            for name in ("router", "w1", "b1", "w2", "b2"):
                sd[f"{key}.moe.{name}"] = _leaf(p, "moe", name)
        else:
            _dense(sd, f"{key}.linear1", p["linear1"])
            _dense(sd, f"{key}.linear2", p["linear2"])
    return sd
