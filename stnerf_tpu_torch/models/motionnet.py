"""MotionNet — per-layer scene-flow MLP.

Counterpart of ``stnerf_tpu/models/motionnet.py`` (ref:
modeling/motion_net.py:5-71): positional encoding L=10 of (x, y, z, id),
then 6 linears (enc -> W x5 -> 3) with ReLU between. With ``input_time``
the id's encoding is the floor/ceil blend that is exact at integer ids.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops.encoding import (encoding_dim, lerp_encoded_time_planar,
                            positional_encoding_planar)
from .mlp import make_mlp, mlp_planar


@dataclasses.dataclass(frozen=True)
class MotionNetSpec:
    c_input: int = 4
    include_input: bool = True
    width: int = 128
    freqs: int = 10
    input_time: bool = False

    @property
    def in_dim(self) -> int:
        return encoding_dim(self.c_input, self.freqs, self.include_input)


class MotionNet(nn.Module):
    def __init__(self, spec: MotionNetSpec,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.spec = spec
        W = spec.width
        self.net = make_mlp([spec.in_dim, W, W, W, W, W, 3], generator)

    def forward(self, xyz: torch.Tensor, ids: torch.Tensor, dtype=None,
                recursive: bool = False) -> torch.Tensor:
        """xyz (3, ...), ids (...) -> flow (3, ...)."""
        spec = self.spec
        if spec.input_time:
            enc = lerp_encoded_time_planar(xyz, ids, spec.freqs,
                                           spec.include_input, recursive)
        else:
            enc = positional_encoding_planar(torch.cat([xyz, ids[None]], 0),
                                             spec.freqs, spec.include_input,
                                             recursive)
        return mlp_planar(self.net, enc, dtype)
