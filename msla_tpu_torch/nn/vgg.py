"""VGG16 feature extractor in torchvision's layout (port of msla_tpu/nn/vgg.py).

NCHW, (..., 3, H, W) → (..., 512, H/32, W/32): the leading dimensions are
flattened into one batch and restored, as flax's ``Conv`` takes any number of
them. ``features`` is torchvision's ``vgg16().features``: Conv2d 3×3 with
padding 1, ReLU and 2×2 max-pools of stride 2 that floor odd sizes, as flax's
VALID pooling does (51 → 25 → 12 → 6 → 3 → 1). Its state_dict keys are
``features.{0,2,5,...,28}.{weight,bias}``, so a torchvision ``vgg16()``
state_dict without its ``classifier.*`` keys loads with ``strict=True``, and
the JAX package's ``vgg16_params_from_torch`` reads the port's as it is.

The weights are frozen: the stack extracts features, and its gradient reaches
its input alone (the JAX ``PerceptualLoss`` stops it at the parameters). That
gradient is ``_InputAdjoint``'s: the forward keeps the weights, each ReLU's
mask and each pool's argmax, not the convs' inputs, and the backward runs the
convs' input adjoints in fp32 under a scope of its own, whatever scope the
caller's ``backward()`` runs in (cuDNN's TF32 is on by default).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from msla_tpu_torch.device import resolve_device
from msla_tpu_torch.nn.layers import conv2d
from msla_tpu_torch.ops.conv_adjoints import fp32_convs

# torchvision vgg16.features: conv channel plan, 'M' = 2x2 maxpool
VGG16_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M")
#: each conv's index in ``features`` (a conv and its ReLU take two, a pool one)
VGG16_CONV_INDICES = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def _stack(x: torch.Tensor, params: tuple[torch.Tensor, ...],
           saved: list[torch.Tensor] | None = None) -> torch.Tensor:
    """The feature stack on an (N, 3, H, W) batch, convs in fp32; with
    ``saved``, each ReLU's mask and each pool's argmax appended in order."""
    convs = iter(zip(params[0::2], params[1::2]))
    with fp32_convs():
        for spec in VGG16_PLAN:
            if spec == "M":
                if saved is None:
                    x = F.max_pool2d(x, 2, 2)
                else:
                    x, argmax = F.max_pool2d(x, 2, 2, return_indices=True)
                    saved.append(argmax)
                continue
            w, b = next(convs)
            x = torch.relu_(F.conv2d(x, w, b, padding=1))
            if saved is not None:
                saved.append(x > 0)
    return x


class _InputAdjoint(torch.autograd.Function):
    """The stack with its input's gradient alone: the weights' and biases'
    are never computed (they are frozen)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, *params: torch.Tensor) -> torch.Tensor:
        saved: list[torch.Tensor] = []
        y = _stack(x, params, saved)
        ctx.save_for_backward(*params[0::2], *saved)
        ctx.n_params = len(params)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        tensors = ctx.saved_tensors
        n_conv = ctx.n_params // 2
        weights, saved = list(tensors[:n_conv]), list(tensors[n_conv:])
        with fp32_convs():
            for spec in reversed(VGG16_PLAN):
                if spec == "M":
                    argmax = saved.pop()
                    g = F.max_unpool2d(g, argmax, 2, 2, output_size=saved[-1].shape[-2:])
                    continue
                mask, w = saved.pop(), weights.pop()
                g = g * mask
                x_shape = (g.shape[0], w.shape[1], *g.shape[2:])
                g = torch.ops.aten.convolution_backward(
                    g, g.new_empty(1).expand(x_shape), w, None, [1, 1], [1, 1], [1, 1],
                    False, [0, 0], 1, [True, False, False])[0]
        return (g, *([None] * ctx.n_params))


class VGG16Features(nn.Module):
    """NCHW feature stack equivalent to torchvision vgg16().features, frozen.

    Weights and biases U(±1/√(9·C_in)), the JAX module's init, drawn on the
    CPU from ``generator`` (one seeded with 0 if None) and moved to
    ``device`` (None means the card)."""

    def __init__(self, *, generator: torch.Generator | None = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        layers: list[nn.Module] = []
        cin = 3
        for spec in VGG16_PLAN:
            if spec == "M":
                layers.append(nn.MaxPool2d(2, 2))
                continue
            layers += [conv2d(cin, int(spec), 3, padding=1, generator=generator, device=dev),
                       nn.ReLU(inplace=True)]
            cin = int(spec)
        self.features = nn.Sequential(*layers)
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        params = tuple(self.parameters())
        if any(p.requires_grad for p in params):
            raise ValueError("VGG16Features computes its input's gradient alone: keep its "
                             "parameters frozen (requires_grad_(False))")
        lead = x.shape[:-3]
        x = x.reshape(-1, *x.shape[-3:])
        if torch.is_grad_enabled() and x.requires_grad:
            y = _InputAdjoint.apply(x, *params)
        else:
            y = _stack(x, params)
        return y.reshape(*lead, *y.shape[1:])
