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

Training resumes from any of the three (:func:`resume_checkpoint`): the
port's file restores the model, optimizer and scheduler; a JAX ``.ckpt``
its parameters and its optax state, mapped onto torch's optimizer and
schedule (:func:`load_optax_state`); a reference ``.pt`` its parameters,
with a fresh optimizer at epoch 0.
"""

from __future__ import annotations

import glob
import importlib
import math
import os
import pickle
import re

import numpy as np
import torch

from ..models.convert import export_jax_params, load_jax_params
from ..models.io_torch import load_reference_checkpoint, state_dict_from_params
from ..models.layered import LayeredModel

_STEM = "stnerf_torch_checkpoint"
_FOREIGN_STEM = "layered_rfnr_checkpoint"
FORMAT = "stnerf_tpu_torch.v1"


def save_checkpoint(output_dir: str, model, optimizer=None, scheduler=None,
                    epoch: int = 0, step: int | None = None,
                    optimizer_state: dict | None = None) -> str:
    """``optimizer_state`` (default: ``optimizer.state_dict()``) is the
    optimizer state to write: a layer-sharded run's made whole
    (``parallel.gather_whole``)."""
    os.makedirs(output_dir, exist_ok=True)
    name = f"{_STEM}_{epoch}.pt" if step is None else f"{_STEM}_{epoch}_{step}.pt"
    path = os.path.join(output_dir, name)
    if optimizer_state is None and optimizer is not None:
        optimizer_state = optimizer.state_dict()
    blob = {"format": FORMAT, "epoch": epoch, "step": step or 0,
            "model": model.state_dict(),
            "optimizer": optimizer_state,
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
    """Newest checkpoint in ``output_dir``, or None: the port's own files,
    and the JAX package's ``.ckpt`` and the reference's ``.pt`` files by the
    JAX package's naming (``layered_rfnr_checkpoint_*``), which
    :func:`load_params_any` reads. Newest by epoch, then step, an epoch's
    own file (``_{epoch}``, written at its end) after its mid-epoch files
    (``_{epoch}_{step}``). The JAX package ranks an epoch's own file
    before them, so its resume after a finished epoch replays the epoch's
    tail."""
    if not os.path.isdir(output_dir):
        return None
    best, best_key = None, (-1, -1)
    for path in glob.glob(os.path.join(output_dir, "*_checkpoint_*")):
        m = re.match(rf"(?:{_STEM}|{_FOREIGN_STEM})_(\d+)(?:_(\d+))?\.(ckpt|pt)$",
                     os.path.basename(path))
        if not m:
            continue
        key = (int(m.group(1)), int(m.group(2)) if m.group(2) else math.inf)
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
    pickled with and, as ``name``, its class's name; nothing else."""

    name = ""

    def __new__(cls, *args, **kwargs):
        return tuple.__new__(cls, args)


_OPTAX_CLASSES: dict = {}


def _optax_class(name: str) -> type:
    """The :class:`_OptaxState` stand-in for the optax class ``name``."""
    if name not in _OPTAX_CLASSES:
        _OPTAX_CLASSES[name] = type(name, (_OptaxState,), {"name": name})
    return _OPTAX_CLASSES[name]


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
            return _optax_class(name)
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
    jax or optax -> {"params": numpy pytree, "opt_state", "epoch", "step"}.
    The optax state comes as inert stand-ins (tuples that keep their optax
    class's name) for :func:`load_optax_state`; None if the file has none."""
    with open(path, "rb") as f:
        blob = _JaxCheckpointUnpickler(f).load()
    if not isinstance(blob, dict) or "params" not in blob:
        raise ValueError(f"{path} is not a JAX package checkpoint")
    return {"params": blob["params"], "opt_state": blob.get("opt_state"),
            "epoch": int(blob.get("epoch", 0)), "step": int(blob.get("step", 0))}


def _state_names(state) -> list:
    """An optax chain's state -> its states' class names, nested as chained."""
    if isinstance(state, _OptaxState):
        return state.name
    if isinstance(state, tuple):
        return [_state_names(x) for x in state]
    return type(state).__name__


def load_optax_state(opt_state, cfg, model, optimizer, scheduler=None) -> None:
    """Map the optax state of a JAX ``.ckpt`` (``load_jax_checkpoint``) onto
    the port's optimizer and schedule for ``cfg`` (``make_optimizer``), in
    place. The state is that of JAX ``make_optimizer``'s chain
    (``stnerf_tpu/engine/solver.py:80-100``): ``add_decayed_weights``'s
    empty state with WEIGHT_DECAY, then ``ScaleByAdamState(count, mu, nu)``
    (each parameter's Adam ``step``, ``exp_avg`` and ``exp_avg_sq``) or
    SGD's ``TraceState`` (its ``momentum_buffer``), then the schedule's
    count (``scheduler.last_epoch`` and each group's rate), the whole
    wrapped with a masked state when FROZEN_GROUPS is set (the frozen
    parameter group). Parameters pair by the names ``load_jax_params``
    uses. A state of another structure raises: a changed optimizer, weight
    decay, momentum or FROZEN_GROUPS across the resume."""
    s = cfg.SOLVER
    name = s.OPTIMIZER_NAME.lower()
    chain = ["EmptyState"] if s.WEIGHT_DECAY else []
    if name == "adam":
        chain.append("ScaleByAdamState")
    elif name == "sgd" and s.MOMENTUM:
        chain.append("TraceState")
    chain.append("ScaleByScheduleState")
    frozen = bool(list(s.FROZEN_GROUPS or []))
    expected = [chain, "MaskedState"] if frozen else chain
    found = _state_names(opt_state)
    if found != expected:
        raise ValueError(
            f"the checkpoint's optimizer state {found} does not match the optimizer "
            f"{expected} of this config (OPTIMIZER_NAME {s.OPTIMIZER_NAME}, WEIGHT_DECAY "
            f"{s.WEIGHT_DECAY}, MOMENTUM {s.MOMENTUM}, FROZEN_GROUPS "
            f"{list(s.FROZEN_GROUPS or [])}): it changed across the resume")
    states = opt_state[0] if frozen else opt_state
    count = int(np.asarray(states[-1][0]))
    params = list(model.parameters())

    def per_param(tree) -> list:
        holder = load_jax_params(LayeredModel(model.spec, device=params[0].device), tree)
        return [h.detach().clone() for h in holder.parameters()]

    if name == "adam":
        adam = states[-2]
        step = int(np.asarray(adam[0]))
        for p, mu, nu in zip(params, per_param(adam[1]), per_param(adam[2])):
            optimizer.state[p] = {"step": torch.tensor(float(step)), "exp_avg": mu,
                                  "exp_avg_sq": nu}
    elif s.MOMENTUM:
        for p, buf in zip(params, per_param(states[-2][0])):
            optimizer.state[p] = {"momentum_buffer": buf}
    if scheduler is not None:
        scheduler.last_epoch = count
        lrs = [base * fn(count) for base, fn in zip(scheduler.base_lrs, scheduler.lr_lambdas)]
        for group, lr in zip(optimizer.param_groups, lrs):
            group["lr"] = lr
        scheduler._last_lr = lrs


def resume_checkpoint(path: str, cfg, model, optimizer, scheduler=None) -> dict:
    """Restore training from the checkpoint at ``path`` in place -> {"epoch",
    "step", "optimizer"}: the port's own file (model, optimizer, schedule:
    :func:`load_checkpoint`), a JAX ``.ckpt`` (parameters, and its optax
    state through :func:`load_optax_state`; a file without one keeps the
    fresh optimizer) or a reference ``.pt`` (parameters only, epoch 0, the
    optimizer fresh, as the JAX entry point imports it). ``optimizer``
    says whether an optimizer state was restored."""
    name = os.path.basename(path)
    if name.startswith(_STEM):
        return {**load_checkpoint(path, model, optimizer, scheduler), "optimizer": True}
    if name.startswith(_FOREIGN_STEM) and name.endswith(".ckpt"):
        blob = load_jax_checkpoint(path)
        load_jax_params(model, blob["params"])
        if blob["opt_state"] is not None:
            load_optax_state(blob["opt_state"], cfg, model, optimizer, scheduler)
        return {"epoch": blob["epoch"], "step": blob["step"],
                "optimizer": blob["opt_state"] is not None}
    load_params_any(path, model)
    return {"epoch": 0, "step": 0, "optimizer": False}


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
