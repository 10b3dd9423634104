"""JAX VQVAENet params → the port's state_dict.

The port keeps the reference torch model's key names. Weight layouts:

* flax Conv kernel (k, in, out)                              → Conv1d (out, in, k)
* flax ConvTranspose (transpose_kernel=True) kernel (k, out, in) → ConvTranspose1d (in, out, k)

Reversing the axes is the map for both. The params come in as a nested dict
of arrays (numpy, or anything ``np.asarray`` takes); nothing of JAX is needed.
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
