"""Validation rendering and metric sweeps (counterpart of
``stnerf_tpu/engine/evaluate.py``; ref: engine/layered_trainer.py:17-130
TensorBoard image panels; :357-421 MAE/PSNR/SSIM sweep over fixed views).

The TensorBoard event writer (the JAX package's ``utils/tb_writer.py``) is
not ported yet: ``swriter`` must stay None.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..models import EditState
from ..ops.metrics import mae as mae_fn, psnr as psnr_fn, ssim as ssim_fn
from ..render.chunked import render_rays_chunked


def _metric(fn, a: np.ndarray, b: np.ndarray) -> float:
    return float(fn(torch.as_tensor(a, dtype=torch.float32),
                    torch.as_tensor(b, dtype=torch.float32)))


def render_view(model, spec, scene, inputs, H, W, chunk=8192):
    # Validation measures the EXACT model semantics: the inference
    # approximations (fast fine stage, early-exit march — production
    # defaults in TPU.*) are stripped here because mid-training coarse and
    # fine nets disagree, which would fold approximation error into the
    # quality metric the trainer reports.
    spec = dataclasses.replace(spec, fast_fine=False, coarse_exit_segments=0)
    out = render_rays_chunked(model, spec, scene, inputs, chunk=chunk)
    color = out.fine.color.reshape(H, W, 3)
    return color, out


def make_val_fn(cfg, spec, scene, view_scene, logger, swriter=None):
    """Build the periodic-validation callback used by do_train: renders one
    labeled view and logs its PSNR. -> val_fn(model, epoch) -> PSNR."""
    if swriter is not None:
        raise NotImplementedError("the TensorBoard event writer is not ported to "
                                  "stnerf_tpu_torch yet")
    rng = np.random.default_rng(123)

    def val_fn(model, epoch):
        inputs, rgbs, labels, image, view, frame = view_scene.get_random_image(rng)
        _, H, W = image.shape
        color, _ = render_view(model, spec, scene, inputs, H, W,
                               chunk=cfg.TPU.RENDER_CHUNK)
        gt = np.moveaxis(image, 0, -1)
        val_psnr = _metric(psnr_fn, color, gt)
        logger.info("Validation - Epoch %d view %d frame %d PSNR %.2f",
                    epoch, view, frame, val_psnr)
        return val_psnr

    return val_fn


def do_evaluate(model, spec, scene, view_scene, views, frames,
                chunk=8192, save_dir=None):
    """Metric sweep over (view, frame) pairs -> dict of mean MAE/PSNR/SSIM
    (ref: engine/layered_trainer.py:357-421)."""
    from ..data.png import write_png

    maes, psnrs, ssims = [], [], []
    for v in views:
        for f in frames:
            inputs, rgbs, labels, image = view_scene.get_fixed_image(v, f)
            _, H, W = image.shape
            color, _ = render_view(model, spec, scene, inputs, H, W, chunk)
            gt = np.moveaxis(image, 0, -1)
            maes.append(_metric(mae_fn, color, gt))
            psnrs.append(_metric(psnr_fn, color, gt))
            ssims.append(_metric(ssim_fn, color, gt))
            if save_dir:
                os.makedirs(save_dir, exist_ok=True)
                write_png(os.path.join(save_dir, f"v{v}_f{f}.png"),
                          (np.clip(color, 0.0, 1.0) * 255).astype(np.uint8))
    result = {"mae": float(np.mean(maes)), "psnr": float(np.mean(psnrs)),
              "ssim": float(np.mean(ssims)), "per_view_psnr": psnrs}
    if save_dir:
        with open(os.path.join(save_dir, "metrics.json"), "w") as fh:
            json.dump(result, fh, indent=2)
    return result
