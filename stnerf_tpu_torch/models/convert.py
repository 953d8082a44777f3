"""Move parameters between a :class:`LayeredModel` and the JAX package's
parameter pytree.

The pytree (``stnerf_tpu.models.init_layered_params`` or a checkpoint's
params, with numpy leaves) stores linears as ``{"w": (in, out), "b":
(out,)}``; performer nets (``layers_coarse``, ``layers_fine``, ``motion``)
carry a leading L axis on every leaf. :func:`load_jax_params` copies such a
pytree into a model, and :func:`export_jax_params` writes a model's
parameters (or their gradients) out as one, so both packages compute — and
differentiate — the same field from the same numbers. The view-deform net
(``view_deform``, a MotionNet pytree) and the pose refinement
(``cam_pose``: ``rvec`` (C, 4), ``tvec`` (C, 3)) travel too.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .layered import LayeredModel

_SPACENET_KEYS = ("stage1", "stage2", "density", "rgb")


@torch.no_grad()
def load_linears(layers: nn.ModuleList, tree: list, index: int | None = None,
                 name: str = "net"):
    """Copy a list of JAX linears (``[{"w", "b"}]``, taking slice ``index``
    of a stacked leading axis) into ``layers``."""
    if len(layers) != len(tree):
        raise ValueError(f"{name}: {len(tree)} layers in the pytree, "
                         f"{len(layers)} in the model")
    for i, (layer, p) in enumerate(zip(layers, tree)):
        w, b = np.asarray(p["w"]), np.asarray(p["b"])
        if index is not None:
            w, b = w[index], b[index]
        if w.T.shape != tuple(layer.weight.shape) or b.shape != tuple(layer.bias.shape):
            raise ValueError(f"{name}[{i}]: pytree {w.shape}/{b.shape} does not "
                             f"fit {tuple(layer.weight.shape)}")
        layer.weight.copy_(torch.tensor(w.T, dtype=torch.float32))
        layer.bias.copy_(torch.tensor(b, dtype=torch.float32))
    return layers


@torch.no_grad()
def load_spacenet(net, tree: dict, index: int | None = None,
                  name: str = "spacenet"):
    """Copy one JAX SpaceNet pytree (or slice ``index`` of a stack)."""
    for key in _SPACENET_KEYS:
        load_linears(getattr(net, key), tree[key], index, f"{name}.{key}")
    return net


@torch.no_grad()
def load_jax_params(model: LayeredModel, tree: dict) -> LayeredModel:
    """Copy a JAX parameter pytree into ``model`` in place; -> model."""
    expected = {"bkgd_coarse", "bkgd_fine", "layers_coarse"}
    if model.layers_fine is not None:
        expected.add("layers_fine")
    if model.motion is not None:
        expected.add("motion")
    if model.bkgd_motion is not None:
        expected.add("bkgd_motion")
    if model.view_deform is not None:
        expected.add("view_deform")
    if model.cam_pose is not None:
        expected.add("cam_pose")
    if set(tree) != expected:
        raise ValueError(f"pytree groups {sorted(tree)} do not match the "
                         f"model's {sorted(expected)}")
    load_spacenet(model.bkgd_coarse, tree["bkgd_coarse"], None, "bkgd_coarse")
    load_spacenet(model.bkgd_fine, tree["bkgd_fine"], None, "bkgd_fine")
    for group in ("layers_coarse", "layers_fine"):
        nets = getattr(model, group)
        for i, net in enumerate(nets or ()):
            load_spacenet(net, tree[group], i, f"{group}[{i}]")
    for i, net in enumerate(model.motion or ()):
        load_linears(net.net, tree["motion"]["net"], i, f"motion[{i}]")
    if model.bkgd_motion is not None:
        load_linears(model.bkgd_motion.net, tree["bkgd_motion"]["net"], None,
                    "bkgd_motion")
    if model.view_deform is not None:
        load_linears(model.view_deform.net, tree["view_deform"]["net"], None,
                     "view_deform")
    if model.cam_pose is not None:
        for name in ("rvec", "tvec"):
            p, v = getattr(model.cam_pose, name), np.asarray(tree["cam_pose"][name])
            if v.shape != tuple(p.shape):
                raise ValueError(f"cam_pose.{name}: pytree {v.shape} does not fit "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.tensor(v, dtype=torch.float32))
    return model


def _value(p: nn.Parameter, grad: bool) -> np.ndarray:
    """A parameter, or its gradient (zero where no loss reached it, as in
    JAX), as a numpy array."""
    t = (p.grad if p.grad is not None else torch.zeros_like(p)) if grad else p
    return t.detach().cpu().numpy()


def export_linears(layers: nn.ModuleList, grad: bool = False) -> list:
    """``layers`` (or their gradients) as JAX linears ``[{"w", "b"}]``."""
    return [{"w": _value(layer.weight, grad).T.copy(), "b": _value(layer.bias, grad)}
            for layer in layers]


def export_spacenet(net, grad: bool = False) -> dict:
    """One SpaceNet (or its gradients) as a JAX SpaceNet pytree."""
    return {key: export_linears(getattr(net, key), grad) for key in _SPACENET_KEYS}


def _stack(trees: list):
    if not trees:  # no performers: the JAX package's empty group
        return {}
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], list):
        return [_stack(list(items)) for items in zip(*trees)]
    return np.stack(trees)


def export_jax_params(model: LayeredModel, grad: bool = False) -> dict:
    """The inverse of :func:`load_jax_params`: the model's parameters — or,
    with ``grad``, their ``.grad`` — as a JAX parameter pytree of numpy
    arrays (performer groups stacked on a leading L axis)."""
    tree = {"bkgd_coarse": export_spacenet(model.bkgd_coarse, grad),
            "bkgd_fine": export_spacenet(model.bkgd_fine, grad),
            "layers_coarse": _stack([export_spacenet(n, grad)
                                     for n in model.layers_coarse])}
    if model.layers_fine is not None:
        tree["layers_fine"] = _stack([export_spacenet(n, grad) for n in model.layers_fine])
    if model.motion is not None:
        tree["motion"] = {"net": _stack([export_linears(m.net, grad) for m in model.motion])}
    if model.bkgd_motion is not None:
        tree["bkgd_motion"] = {"net": export_linears(model.bkgd_motion.net, grad)}
    if model.view_deform is not None:
        tree["view_deform"] = {"net": export_linears(model.view_deform.net, grad)}
    if model.cam_pose is not None:
        tree["cam_pose"] = {name: _value(getattr(model.cam_pose, name), grad)
                            for name in ("rvec", "tvec")}
    return tree
