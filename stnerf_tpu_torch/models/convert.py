"""Load the JAX package's parameter pytree into a :class:`LayeredModel`.

The pytree (``stnerf_tpu.models.init_layered_params`` or a checkpoint's
params, with numpy leaves) stores linears as ``{"w": (in, out), "b":
(out,)}``; performer nets (``layers_coarse``, ``layers_fine``, ``motion``)
carry a leading L axis on every leaf. Both packages then compute the same
field from the same numbers.
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
    return model
