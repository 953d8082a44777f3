"""Checkpoint save, load and discovery.

The port's own format: one ``torch.save`` of the model's, optimizer's and
scheduler's state dicts with the epoch and step
(``stnerf_torch_checkpoint_{epoch}[_{step}].pt``), written and restored by
:func:`save_checkpoint` / :func:`load_checkpoint`.

Two foreign formats load their parameters into a model
(:func:`load_params_any`):

- the JAX package's ``layered_rfnr_checkpoint_*.ckpt``, a pickle of numpy
  pytrees with its optax state (:func:`load_jax_checkpoint` reads it without
  jax or optax, through an unpickler that admits numpy arrays only);
- the reference's ``layered_rfnr_checkpoint_*.pt`` state dicts
  (``models.io_torch``), which :func:`export_reference_checkpoint` also
  writes.

Resuming training from a foreign file (its optax state mapped onto torch's
Adam) is not ported.
"""

from __future__ import annotations

import glob
import importlib
import os
import pickle
import re

import numpy as np
import torch

from ..models.convert import export_jax_params, load_jax_params
from ..models.io_torch import load_reference_checkpoint, state_dict_from_params

_STEM = "stnerf_torch_checkpoint"
_FOREIGN_STEM = "layered_rfnr_checkpoint"
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
    which :func:`load_params_any` reads."""
    if not os.path.isdir(output_dir):
        return None
    best, best_key = None, (-1, -1)
    for path in glob.glob(os.path.join(output_dir, "*_checkpoint_*")):
        m = re.match(rf"(?:{_STEM}|{_FOREIGN_STEM})_(\d+)(?:_(\d+))?\.(ckpt|pt)$",
                     os.path.basename(path))
        if not m:
            continue
        key = (int(m.group(1)), int(m.group(2) or 0))
        if key > best_key:
            best, best_key = path, key
    return best


# -- the JAX package's .ckpt ------------------------------------------------

def _numpy_multiarray():
    try:  # numpy 2
        return importlib.import_module("numpy._core.multiarray")
    except ImportError:  # numpy 1
        return importlib.import_module("numpy.core.multiarray")


class _OptaxState(tuple):
    """Inert stand-in for an optax state NamedTuple: keeps the fields it was
    pickled with and nothing else."""

    def __new__(cls, *args, **kwargs):
        return tuple.__new__(cls, args)


class _JaxCheckpointUnpickler(pickle.Unpickler):
    """Admits numpy arrays, dtypes and scalars (under numpy 1's
    ``numpy.core`` and numpy 2's ``numpy._core`` paths), maps every optax
    class to :class:`_OptaxState`, and refuses every other global."""

    _ARRAY_NAMES = ("_reconstruct", "scalar")

    def find_class(self, module: str, name: str):
        if module in ("numpy.core.multiarray", "numpy._core.multiarray") \
                and name in self._ARRAY_NAMES:
            return getattr(_numpy_multiarray(), name)
        if module == "numpy" and name in ("ndarray", "dtype"):
            return getattr(np, name)
        if module == "optax" or module.startswith("optax."):
            return _OptaxState
        if module == "ml_dtypes" or module.startswith("ml_dtypes."):
            raise pickle.UnpicklingError(
                f"a leaf of this checkpoint has the ml_dtypes dtype {name}; "
                "the port reads float32 parameter masters only (save the "
                "parameters as float32)")
        raise pickle.UnpicklingError(
            f"refusing to unpickle {module}.{name}: a JAX .ckpt holds numpy "
            "arrays and optax states only")


def load_jax_checkpoint(path: str) -> dict:
    """Read a JAX package ``.ckpt`` (``stnerf_tpu.engine.save_checkpoint``:
    a pickle of {"params", "opt_state", "epoch", "step", "format"}) without
    jax or optax -> {"params": numpy pytree, "epoch", "step"}. The optax
    state is unpickled into inert stand-ins and dropped."""
    with open(path, "rb") as f:
        blob = _JaxCheckpointUnpickler(f).load()
    if not isinstance(blob, dict) or "params" not in blob:
        raise ValueError(f"{path} is not a JAX package checkpoint")
    return {"params": blob["params"], "epoch": int(blob.get("epoch", 0)),
            "step": int(blob.get("step", 0))}


# -- any format -------------------------------------------------------------

def load_params_any(path: str, model):
    """Load the parameters of the checkpoint at ``path`` into ``model`` in
    place -> model. The port's own files go through :func:`load_checkpoint`,
    a JAX ``layered_rfnr_checkpoint_*.ckpt`` through
    :func:`load_jax_checkpoint`, and a reference
    ``layered_rfnr_checkpoint_*.pt`` through ``models.io_torch``."""
    name = os.path.basename(path)
    if name.startswith(_STEM):
        load_checkpoint(path, model)
    elif name.startswith(_FOREIGN_STEM) and name.endswith(".ckpt"):
        load_jax_params(model, load_jax_checkpoint(path)["params"])
    elif name.startswith(_FOREIGN_STEM) and name.endswith(".pt"):
        load_jax_params(model, load_reference_checkpoint(path, model.spec))
    else:
        raise ValueError(f"{path}: not a checkpoint name this port reads "
                         f"({_STEM}_*.pt, {_FOREIGN_STEM}_*.ckpt or "
                         f"{_FOREIGN_STEM}_*.pt)")
    return model


def export_reference_checkpoint(path: str, model) -> str:
    """Write ``model``'s parameters as a reference-layout ``.pt``
    (``{"model": state_dict}`` of CPU float32 tensors), the counterpart of
    the JAX package's ``export_reference_checkpoint`` -> ``path``."""
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
          state_dict_from_params(export_jax_params(model), model.spec).items()}
    torch.save({"model": sd}, path)
    return path
