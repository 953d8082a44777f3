"""Training losses (counterpart of ``stnerf_tpu/engine/loss.py``).

* RGB loss: MSE on the coarse and fine mixed composites
  (ref: engine/layered_trainer.py:216-217, layers/loss.py:4-5).
* Mask (alpha segmentation) loss: pushes each performer layer's accumulated
  alpha to 0 on rays labelled background and to 1 on rays labelled as that
  layer, while REMOVE_OUTLIERS is on, for the first epochs
  (ref: engine/layered_trainer.py:218-281), with the reference's gate: the
  term is zero unless it exceeds 5e-4 * N.
"""

from __future__ import annotations

import torch

MASK_LOSS_SCALE = 1e5     # ref: layered_trainer.py:244 (scalar_max)
MASK_LOSS_PENALTY = 1.0   # ref: layered_trainer.py:247
MASK_LOSS_GATE = 0.0005   # ref: layered_trainer.py:264


def rgb_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def mask_alpha_loss(layer_acc: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """layer_acc (L+1, N, 1) per-layer accumulated alpha, labels (N,) int
    segmentation id per ray (0 = background) -> the scaled, gated scalar."""
    acc = layer_acc[..., 0]
    lp1, n = acc.shape
    lbl = labels.long()
    is_bkgd = (lbl == 0).to(acc.dtype)
    # outliers: performer layers' alpha on background-labelled rays
    outlier = torch.sum(acc[1:].abs() * is_bkgd[None])
    # inliers: each layer's alpha on its own rays (background included)
    own = (lbl[None] == torch.arange(lp1, device=acc.device)[:, None]).to(acc.dtype)
    inlier = torch.sum((1.0 - acc).abs() * own)
    raw = outlier * MASK_LOSS_PENALTY + inlier
    return torch.where(raw > n * MASK_LOSS_GATE, raw / MASK_LOSS_SCALE,
                       torch.zeros_like(raw))
