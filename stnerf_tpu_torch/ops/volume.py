"""Volume rendering and the cross-layer depth merge.

Counterpart of ``stnerf_tpu/ops/volume.py``, with the reference's numerics
(ref: layers/render_layer.py:8-47): ``alpha = 1 - exp(-relu(sigma) * delta)``,
exclusive transmittance over ``1 - alpha + 1e-10``, the last delta padded
with ``boarder_weight``, and the sigmoid on raw rgb applied here. Training
differentiates through all of it; the transmittance's cumulative product
has the JAX package's closed-form backward.

Color, depth and acc are elementwise products summed over samples, never a
matrix product, so a float32 result does not depend on the TF32 switches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RenderedRays(NamedTuple):
    color: torch.Tensor    # (N, 3)
    depth: torch.Tensor    # (N, 1)
    acc: torch.Tensor      # (N, 1)
    weights: torch.Tensor  # (N, S, 1)


class _CumprodBounded(torch.autograd.Function):
    """``torch.cumprod(f, -1)`` for transmittance factors ``1 - alpha +
    1e-10``, with the JAX package's backward (``_cumprod_bounded``): with
    P = cumprod(f), df_i = (sum_{m >= i} dP_m P_m) / max(f_i, 1e-10) — one
    reversed cumulative sum and a divide, defined at saturated samples
    (alpha = 1, e.g. at the 1e10 border delta)."""

    @staticmethod
    def forward(ctx, f):
        p = torch.cumprod(f, -1)
        ctx.save_for_backward(f, p)
        return p

    @staticmethod
    def backward(ctx, dp):
        f, p = ctx.saved_tensors
        s = torch.flip(torch.cumsum(torch.flip(dp * p, (-1,)), -1), (-1,))
        return s / torch.clamp(f, min=1e-10)


def render_weights(sigma: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """(..., S) raw density and segment lengths -> (..., S) weights."""
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * delta)
    trans = _CumprodBounded.apply(1.0 - alpha + 1e-10)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    return alpha * trans


def volume_render_planar(t: torch.Tensor, rgb: torch.Tensor,
                         sigma: torch.Tensor,
                         boarder_weight: float = 1e10) -> RenderedRays:
    """t (..., N, S) ascending, rgb (..., 3, N, S) raw, sigma (..., N, S)
    raw; leading axes (e.g. the layer axis) are batch axes."""
    delta = t[..., 1:] - t[..., :-1]
    delta = torch.cat([delta, torch.full_like(delta[..., :1], boarder_weight)],
                      -1)
    w = render_weights(sigma, delta)
    color = (w.unsqueeze(-3) * torch.sigmoid(rgb)).sum(-1).transpose(-1, -2)
    depth = (w * t).sum(-1, keepdim=True)
    acc = w.sum(-1, keepdim=True)
    return RenderedRays(color, depth, acc, w[..., None])


def merge_layers_planar(t: torch.Tensor, rgb: torch.Tensor,
                        sigma: torch.Tensor):
    """Depth-sort the union of all layers' samples
    (ref: modeling/layered_rfrender.py:425-429).

    t (L, N, S), rgb (L, 3, N, S), sigma (L, N, S)
    -> t (N, L*S), rgb (3, N, L*S), sigma (N, L*S) sorted by t.
    """
    L, N, S = t.shape
    t_cat = t.permute(1, 0, 2).reshape(N, L * S)
    sig_cat = sigma.permute(1, 0, 2).reshape(N, L * S)
    rgb_cat = rgb.permute(1, 2, 0, 3).reshape(3, N, L * S)
    t_s, order = torch.sort(t_cat, dim=-1)
    return (t_s, rgb_cat.gather(-1, order.expand(3, N, L * S)),
            sig_cat.gather(-1, order))


def sort_merge_t(t_a: torch.Tensor, t_b: torch.Tensor) -> torch.Tensor:
    """Sorted union of two per-ray depth sets, (N,S1),(N,S2) -> (N,S1+S2)
    (ref: modeling/layered_rfrender.py:462)."""
    return torch.sort(torch.cat([t_a, t_b], -1), dim=-1).values
