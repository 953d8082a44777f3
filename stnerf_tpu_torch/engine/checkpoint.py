"""Checkpoints in the port's own format: one ``torch.save`` of the model's,
optimizer's and scheduler's state dicts with the epoch and step
(``stnerf_torch_checkpoint_{epoch}[_{step}].pt``). Reading the JAX
package's ``.ckpt`` pickles and the reference's ``.pt`` state dicts is not
ported yet.
"""

from __future__ import annotations

import glob
import os
import re

import torch

_STEM = "stnerf_torch_checkpoint"
FORMAT = "stnerf_tpu_torch.v1"


def save_checkpoint(output_dir: str, model, optimizer=None, scheduler=None,
                    epoch: int = 0, step: int | None = None) -> str:
    os.makedirs(output_dir, exist_ok=True)
    name = f"{_STEM}_{epoch}.pt" if step is None else f"{_STEM}_{epoch}_{step}.pt"
    path = os.path.join(output_dir, name)
    blob = {"format": FORMAT, "epoch": epoch, "step": step or 0,
            "model": model.state_dict(),
            "optimizer": None if optimizer is None else optimizer.state_dict(),
            "scheduler": None if scheduler is None else scheduler.state_dict()}
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, model, optimizer=None, scheduler=None) -> dict:
    """Restore the states saved by :func:`save_checkpoint` in place (each
    onto the device its target already lives on); -> {"epoch", "step"}."""
    device = next(model.parameters()).device
    blob = torch.load(path, map_location=device, weights_only=True)
    if blob.get("format") != FORMAT:
        raise ValueError(f"{path} is not a {FORMAT} checkpoint")
    model.load_state_dict(blob["model"])
    if optimizer is not None and blob["optimizer"] is not None:
        optimizer.load_state_dict(blob["optimizer"])
    if scheduler is not None and blob["scheduler"] is not None:
        scheduler.load_state_dict(blob["scheduler"])
    return {"epoch": blob["epoch"], "step": blob["step"]}


def latest_checkpoint(output_dir: str):
    """Newest checkpoint in ``output_dir`` by (epoch, step), or None: the
    port's own files, and the JAX package's ``.ckpt`` and the reference's
    ``.pt`` files by the JAX package's naming (``layered_rfnr_checkpoint_*``),
    which :func:`load_checkpoint` refuses."""
    if not os.path.isdir(output_dir):
        return None
    best, best_key = None, (-1, -1)
    for path in glob.glob(os.path.join(output_dir, "*_checkpoint_*")):
        m = re.match(rf"(?:{_STEM}|layered_rfnr_checkpoint)_(\d+)(?:_(\d+))?\.(ckpt|pt)$",
                     os.path.basename(path))
        if not m:
            continue
        key = (int(m.group(1)), int(m.group(2) or 0))
        if key > best_key:
            best, best_key = path, key
    return best
