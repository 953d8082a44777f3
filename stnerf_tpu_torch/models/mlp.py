"""Linear stacks in the channel-leading (planar) layout.

Counterpart of ``stnerf_tpu/models/mlp.py``. Layers are ``nn.Linear``
(weight (out, in)); the JAX package stores (in, out), and
``models/convert.py`` transposes. Init matches ``mlp.init_linear``: weight
and bias both U(-1/sqrt(d_in), 1/sqrt(d_in)), drawn from a generator.

A ``dtype`` of ``torch.bfloat16`` computes a layer as the JAX package's bf16
matmul with float32 accumulation does: inputs and weights are rounded to
bf16 (``ops.rounding.round_to``) and multiplied in float32.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..ops.rounding import round_to


def make_mlp(dims: Sequence[int],
             generator: torch.Generator | None = None) -> nn.ModuleList:
    """Linears dims[0] -> dims[1] -> ... -> dims[-1]."""
    layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
    with torch.no_grad():
        for layer in layers:
            bound = 1.0 / math.sqrt(layer.in_features)
            layer.weight.uniform_(-bound, bound, generator=generator)
            layer.bias.uniform_(-bound, bound, generator=generator)
    return layers


def linear_planar(layer: nn.Linear, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """y = W x + b; x (in, ...) -> (out, ...)."""
    w = round_to(layer.weight, dtype)
    y = w @ round_to(x, dtype).reshape(x.shape[0], -1)
    return (y + layer.bias[:, None]).reshape(w.shape[0], *x.shape[1:])


def mlp_planar(layers: nn.ModuleList, x: torch.Tensor, dtype=None,
               final_activation: bool = False) -> torch.Tensor:
    """ReLU after every layer but the last (and the last too if
    ``final_activation``)."""
    n = len(layers)
    for i, layer in enumerate(layers):
        x = linear_planar(layer, x, dtype)
        if i < n - 1 or final_activation:
            x = torch.relu(x)
    return x
