"""SpaceNet — the per-layer radiance field MLP.

Counterpart of ``stnerf_tpu/models/spacenet.py`` (ref:
modeling/spacenet.py:13-160): positional encodings pos L=10, dir L=4,
time L=10; a 4-layer trunk, a 3-layer stage on ``[trunk | pos_enc]``, a
density head, and an rgb head behind a ReLU over
``[features | dir_enc | time_enc]`` (the ReLU also clips the encodings — a
reference quirk kept for checkpoint parity).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops.encoding import encoding_dim, positional_encoding_planar
from .mlp import linear_planar, make_mlp, mlp_planar


@dataclasses.dataclass(frozen=True)
class SpaceNetSpec:
    use_dir: bool = True
    use_time: bool = False
    deep_rgb: bool = False
    include_input: bool = True
    backbone_dim: int = 256
    head_dim: int = 128
    pos_freqs: int = 10
    dir_freqs: int = 4
    time_freqs: int = 10

    @property
    def pos_dim(self) -> int:
        return encoding_dim(3, self.pos_freqs, self.include_input)

    @property
    def dir_dim(self) -> int:
        return encoding_dim(3, self.dir_freqs, self.include_input) if self.use_dir else 0

    @property
    def time_dim(self) -> int:
        return encoding_dim(1, self.time_freqs, self.include_input) if self.use_time else 0


class SpaceNet(nn.Module):
    def __init__(self, spec: SpaceNetSpec,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.spec = spec
        W, H = spec.backbone_dim, spec.head_dim
        rgb_in = W + spec.dir_dim + spec.time_dim
        self.stage1 = make_mlp([spec.pos_dim, W, W, W, W], generator)
        self.stage2 = make_mlp([W + spec.pos_dim, W, W, W], generator)
        self.density = make_mlp([W, 1], generator)
        self.rgb = make_mlp([rgb_in, H, H, H, 3] if spec.deep_rgb
                            else [rgb_in, H, 3], generator)

    def forward(self, pos: torch.Tensor, dirs: torch.Tensor | None,
                times: torch.Tensor | None, dtype=None):
        """pos (3, ...), dirs (3, ...) or None, times (...) or None
        -> (rgb (3, ...) raw, sigma (...) raw)."""
        spec = self.spec
        p_enc = positional_encoding_planar(pos, spec.pos_freqs, spec.include_input)
        x = mlp_planar(self.stage1, p_enc, dtype, final_activation=True)
        x = mlp_planar(self.stage2, torch.cat([x, p_enc], 0), dtype,
                       final_activation=True)
        sigma = linear_planar(self.density[0], x, dtype)[0]
        feats = [x]
        if spec.use_dir:
            feats.append(positional_encoding_planar(dirs, spec.dir_freqs,
                                                    spec.include_input))
        if spec.use_time:
            feats.append(positional_encoding_planar(times[None], spec.time_freqs,
                                                    spec.include_input))
        h = torch.relu(torch.cat(feats, 0))
        return mlp_planar(self.rgb, h, dtype), sigma
