"""Conv, linear and embedding layers with the JAX package's initialisers,
drawn from an explicit torch.Generator (port of msla_tpu/nn/layers.py).

Conv and linear weights and biases are U(±1/√fan_in), the torch default family
that the JAX package reproduces: fan_in is in·k for Conv1d's (out, in, k)
weight, out·k for ConvTranspose1d's (in, out, k) weight, in·k² for Conv2d's
(out, in, k, k) weight and in for Linear.
Values are drawn on the CPU and then moved, so one seed gives one model on
every device.

``compute`` names a model's compute dtype, and ``conv``, ``dense`` and
``layer_norm`` apply a layer as flax applies it under that dtype (parameters
stay fp32; only the compute casts).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def compute(compute_dtype: str | None) -> torch.dtype | None:
    """The JAX package's ``compute_dtype``: None (or "float32") for fp32,
    where the layers run as they are, or "bfloat16"."""
    if compute_dtype in (None, "float32"):
        return None
    if compute_dtype == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"compute_dtype={compute_dtype!r}: the port runs None, 'float32' or "
                     "'bfloat16'")


def conv(layer: nn.Conv1d, x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """``layer`` as flax's ``nn.Conv(dtype=dtype)``: in bf16 the input and the
    weight cast, the convolution given in bf16, then the bias added in bf16."""
    if dtype is None:
        return layer(x)
    y = F.conv1d(x.to(dtype), layer.weight.to(dtype), None, layer.stride, layer.padding)
    return y if layer.bias is None else y + layer.bias.to(dtype)[:, None]


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """``layer`` as flax's ``nn.Dense(dtype=dtype)``: in bf16 the input and the
    weight cast, the product given in bf16, then the bias added in bf16."""
    if dtype is None:
        return layer(x)
    return F.linear(x.to(dtype), layer.weight.to(dtype)) + layer.bias.to(dtype)


def layer_norm(layer: nn.LayerNorm, x: torch.Tensor,
               dtype: torch.dtype | None) -> torch.Tensor:
    """``layer`` as flax's ``nn.LayerNorm(dtype=dtype)``: statistics and the
    affine map in fp32 on the widened input, the result in ``dtype``."""
    if dtype is None:
        return layer(x)
    return layer(x.float()).to(dtype)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            deterministic: bool = True, shard: tuple[int, int, int] | None = None
            ) -> torch.Tensor:
    """flax's ``nn.Dropout(rate)``: each element kept with probability
    1 − rate, and a kept one scaled by 1/(1 − rate), in ``x``'s dtype. The
    keep mask is drawn from ``generator`` (``F.dropout`` takes none), which
    must live on ``x``'s device. ``shard`` = (dim, index, parts): ``x`` is
    block ``index`` of ``parts`` along ``dim`` of the whole tensor, whose mask
    is drawn and cut, so the shards drop as the whole does."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout with deterministic=False draws from a torch.Generator: "
                         "pass one")
    if rate >= 1.0:
        return torch.zeros_like(x)
    shape = list(x.shape)
    if shard is not None:
        dim, index, parts = shard
        shape[dim] *= parts
    keep = torch.rand(shape, generator=generator, device=x.device) < 1.0 - rate
    if shard is not None:
        keep = keep.narrow(dim, index * x.shape[dim], x.shape[dim])
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def uniform_(t: torch.Tensor, limit: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        draw = torch.rand(t.shape, generator=generator, dtype=torch.float32)
        t.copy_(draw * (2 * limit) - limit)


def _init_conv(conv: nn.Module, fan_in: int, generator: torch.Generator) -> nn.Module:
    limit = 1.0 / fan_in ** 0.5
    uniform_(conv.weight, limit, generator)
    if conv.bias is not None:
        uniform_(conv.bias, limit, generator)
    return conv


def conv1d(cin: int, cout: int, kernel_size: int, stride: int = 1, padding: int = 0,
           bias: bool = True, *, generator: torch.Generator, device) -> nn.Conv1d:
    conv = nn.utils.skip_init(nn.Conv1d, cin, cout, kernel_size, stride=stride,
                              padding=padding, bias=bias, device=device)
    return _init_conv(conv, cin * kernel_size, generator)


def conv2d(cin: int, cout: int, kernel_size: int, padding: int = 0, *,
           generator: torch.Generator, device) -> nn.Conv2d:
    """nn.Conv2d with flax ``Conv``'s torch-style init: weight and bias
    U(±1/√(cin·k²))."""
    conv = nn.utils.skip_init(nn.Conv2d, cin, cout, kernel_size, padding=padding,
                              device=device)
    return _init_conv(conv, cin * kernel_size ** 2, generator)


def conv_transpose1d(cin: int, cout: int, kernel_size: int, stride: int = 1,
                     padding: int = 0, *, generator: torch.Generator,
                     device) -> nn.ConvTranspose1d:
    conv = nn.utils.skip_init(nn.ConvTranspose1d, cin, cout, kernel_size, stride=stride,
                              padding=padding, device=device)
    return _init_conv(conv, cout * kernel_size, generator)


def linear(cin: int, cout: int, *, generator: torch.Generator, device) -> nn.Linear:
    """nn.Linear with the JAX ``Linear``/``Dense`` init (``torch_kernel_init``,
    ``torch_bias_init``): weight and bias U(±1/√cin)."""
    lin = nn.utils.skip_init(nn.Linear, cin, cout, device=device)
    return _init_conv(lin, cin, generator)


#: flax's truncated normal is cut at ±2σ and rescaled to keep its variance
_TRUNC_STD = 0.87962566103423978


def embedding(num: int, features: int, *, generator: torch.Generator,
              device) -> nn.Embedding:
    """nn.Embedding with flax ``nn.Embed``'s default init,
    variance_scaling(1, "fan_in", "normal", out_axis=0): a normal truncated at
    ±2σ with σ = 1/√features / 0.8796 (the variance of the cut normal is then
    1/features)."""
    emb = nn.utils.skip_init(nn.Embedding, num, features, device=device)
    std = (1.0 / features) ** 0.5 / _TRUNC_STD
    with torch.no_grad():
        draw = torch.empty((num, features), dtype=torch.float32)
        nn.init.trunc_normal_(draw, std=std, a=-2 * std, b=2 * std, generator=generator)
        emb.weight.copy_(draw)
    return emb
