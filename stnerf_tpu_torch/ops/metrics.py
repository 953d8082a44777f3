"""Image quality metrics (counterpart of ``stnerf_tpu/ops/metrics.py``;
ref: utils/metrics.py:4-24). SSIM is not ported yet."""

from __future__ import annotations

import torch


def mse(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(mse(pred, gt))
