"""Image quality metrics (counterpart of ``stnerf_tpu/ops/metrics.py``;
ref: utils/metrics.py:4-24, which used torch + kornia)."""

from __future__ import annotations

import math

import torch


def mse(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


def mae(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - gt))


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(mse(pred, gt))


def _gaussian_kernel(size: int, sigma: float) -> list[float]:
    g = [math.exp(-((i - (size - 1) / 2.0) ** 2) / (2 * sigma ** 2)) for i in range(size)]
    return [v / sum(g) for v in g]


def ssim(pred: torch.Tensor, gt: torch.Tensor, window: int = 3,
         max_val: float = 1.0) -> torch.Tensor:
    """Mean SSIM over an image. pred/gt: (H, W, C) in [0, max_val].

    The reference reports ``1 - 2 * dssim`` with kornia's window-3 dssim
    (ref: utils/metrics.py:19-24), which equals plain mean SSIM; as the JAX
    package, SSIM is computed directly with a gaussian window (sigma = 1.5)
    and valid padding. The window sums are written out as shifted float32
    products, not a convolution: the variance terms (filt(x^2) - mu^2)
    cancel, and a TF32 convolution would leave SSIM far outside [-1, 1] on
    smooth images.
    """
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    k = _gaussian_kernel(window, 1.5)
    H, W = pred.shape[:2]
    h, w = H - window + 1, W - window + 1

    def filt(img):
        out = torch.zeros((h, w) + tuple(img.shape[2:]), dtype=img.dtype, device=img.device)
        for u in range(window):
            for v in range(window):
                out = out + (k[u] * k[v]) * img[u:u + h, v:v + w]
        return out

    mu_p, mu_g = filt(pred), filt(gt)
    sig_p = filt(pred * pred) - mu_p ** 2
    sig_g = filt(gt * gt) - mu_g ** 2
    sig_pg = filt(pred * gt) - mu_p * mu_g
    num = (2 * mu_p * mu_g + c1) * (2 * sig_pg + c2)
    den = (mu_p ** 2 + mu_g ** 2 + c1) * (sig_p + sig_g + c2)
    return torch.mean(num / den)
