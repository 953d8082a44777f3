"""Optimizer and learning-rate schedules (counterpart of
``stnerf_tpu/engine/solver.py``).

The reference's solver (ref: solver/build.py:10-26 Adam;
solver/lr_scheduler.py:12-69): Adam, a per-iteration schedule with linear
warmup over WARMUP_ITERS, then from START_ITERS an exponential decay onto
the LR_SCALE floor by END_ITERS. Weight decay is added to the gradient
before the moment estimates (``torch.optim.Adam``'s ``weight_decay``, the
JAX chain's ``add_decayed_weights``). Frozen parameter groups get no update.
"""

from __future__ import annotations

import bisect
import math

import torch


def _lr_multiplier(warmup_iters: int, start_iters: int, end_iters: int,
                   lr_scale: float):
    def mult(step: int) -> float:
        s = float(step) + 1.0
        if s <= warmup_iters:
            return s / max(warmup_iters, 1)
        if s >= start_iters:
            return ((1.0 - lr_scale) * math.exp(-(s - start_iters) / (end_iters - start_iters))
                    + lr_scale)
        return 1.0

    return mult


def make_lr_schedule(base_lr: float, warmup_iters: int, start_iters: int,
                     end_iters: int, lr_scale: float):
    """step (0 = the first update) -> learning rate
    (ref: solver/lr_scheduler.py:59-69)."""
    mult = _lr_multiplier(warmup_iters, start_iters, end_iters, lr_scale)
    return lambda step: base_lr * mult(step)


def make_warmup_multistep(base_lr: float, milestones, gamma: float = 0.1,
                          warmup_factor: float = 1.0 / 3, warmup_iters: int = 500,
                          warmup_method: str = "linear"):
    """Warmup + multistep decay (ref: solver/lr_scheduler.py:12-55): during
    warmup the factor ramps from ``warmup_factor`` to 1 (or stays constant),
    and the rate is multiplied by ``gamma`` at each milestone <= step."""
    milestones = list(milestones)
    if milestones != sorted(milestones):
        raise ValueError(f"milestones must be increasing, got {milestones}")
    if warmup_method not in ("constant", "linear"):
        raise ValueError(f"warmup_method must be constant|linear, got {warmup_method}")

    def schedule(step: int) -> float:
        wf = 1.0
        if step < warmup_iters:
            if warmup_method == "constant":
                wf = warmup_factor
            else:
                alpha = step / max(warmup_iters, 1)
                wf = warmup_factor * (1.0 - alpha) + alpha
        return base_lr * wf * gamma ** bisect.bisect_right(milestones, step)

    return schedule


def make_frozen_mask(model, frozen_groups) -> dict | None:
    """{group: frozen} over the model's parameter groups ("bkgd_coarse",
    "layers_fine", "motion", ...), or None when nothing is frozen. Unknown
    names raise: a typo that silently trained a "frozen" net would be worse
    than a crash (ref: solver/build.py:20-22)."""
    groups = list(frozen_groups or [])
    if not groups:
        return None
    names = [name for name, child in model.named_children()
             if any(True for _ in child.parameters())]
    unknown = [g for g in groups if g not in names]
    if unknown:
        raise ValueError(f"unknown frozen param groups {unknown}; available: "
                         f"{sorted(names)}")
    return {name: name in groups for name in names}


def make_optimizer(cfg, model, frozen_mask: dict | None = None):
    """-> (optimizer, scheduler). The scheduler is a ``LambdaLR`` whose step
    0 is the first update (as optax counts); call ``scheduler.step()`` after
    each ``optimizer.step()``. Frozen groups sit in a parameter group with
    learning rate 0: their moments still update, their weights do not."""
    s = cfg.SOLVER
    frozen = {name for name, f in (frozen_mask or {}).items() if f}
    active, still = [], []
    for name, child in model.named_children():
        (still if name in frozen else active).extend(child.parameters())
    groups = [{"params": active}]
    if still:
        groups.append({"params": still, "lr": 0.0})
    name = s.OPTIMIZER_NAME.lower()
    if name == "adam":
        opt = torch.optim.Adam(groups, lr=s.BASE_LR, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=s.WEIGHT_DECAY)
    elif name == "sgd":
        opt = torch.optim.SGD(groups, lr=s.BASE_LR, momentum=s.MOMENTUM,
                              weight_decay=s.WEIGHT_DECAY)
    else:
        raise ValueError(f"unknown optimizer {s.OPTIMIZER_NAME}")
    mult = _lr_multiplier(s.WARMUP_ITERS, s.START_ITERS, s.END_ITERS, s.LR_SCALE)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, mult)
