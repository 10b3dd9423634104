"""Audio metrics (port of msla_tpu/ops/metrics.py): L1, MSE and torchmetrics'
scale-invariant SDR (zero_mean=False, with its eps regularisation)."""
from __future__ import annotations

import torch


def l1_loss(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(preds - target))


def mse_loss(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((preds - target) ** 2)


def si_sdr(preds: torch.Tensor, target: torch.Tensor, zero_mean: bool = False) -> torch.Tensor:
    """Scale-invariant signal-to-distortion ratio, per example over the last axis."""
    eps = torch.finfo(preds.dtype).eps
    if zero_mean:
        preds = preds - preds.mean(dim=-1, keepdim=True)
        target = target - target.mean(dim=-1, keepdim=True)
    alpha = ((preds * target).sum(dim=-1, keepdim=True) + eps) / (
        (target ** 2).sum(dim=-1, keepdim=True) + eps)
    target_scaled = alpha * target
    noise = target_scaled - preds
    val = ((target_scaled ** 2).sum(dim=-1) + eps) / ((noise ** 2).sum(dim=-1) + eps)
    return 10.0 * torch.log10(val)


def si_sdr_mean(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Batch mean SI-SDR: the reference always logs ``.mean()``."""
    return si_sdr(preds, target).mean()
