"""Ray sampling: AABB intersection, stratified bins, inverse-CDF resampling.

Counterpart of ``stnerf_tpu/ops/sampling.py``. Randomness comes from an
explicit ``torch.Generator``; ``generator=None`` is the deterministic mode
(bin centres, and the reference's det ``sample_pdf`` with u = linspace).
"""

from __future__ import annotations

import torch

MISS_T = -1e3  # missed-ray sentinel t (ref: layers/RaySamplePoint.py:53)


def ray_aabb_intersect(rays_o: torch.Tensor, rays_d: torch.Tensor,
                       box_min: torch.Tensor, box_max: torch.Tensor):
    """Slab test. rays_o, rays_d (..., 3); boxes (..., 3) broadcastable.
    -> (t_near, t_far, hit); missed rays get t_near = t_far = MISS_T."""
    inv_d = 1.0 / (rays_d + 2.220446049250313e-16)  # np.finfo(float).eps
    t1 = (box_min - rays_o) * inv_d
    t2 = (box_max - rays_o) * inv_d
    t_near = torch.minimum(t1, t2).amax(dim=-1)
    t_far = torch.maximum(t1, t2).amin(dim=-1)
    hit = t_far > t_near
    miss = torch.full_like(t_near, MISS_T)
    return torch.where(hit, t_near, miss), torch.where(hit, t_far, miss), hit


def _uniform(shape, like: torch.Tensor, generator):
    return torch.rand(shape, generator=generator, device=like.device,
                      dtype=like.dtype)


def stratified_between(t_start: torch.Tensor, t_end: torch.Tensor, num: int,
                       generator: torch.Generator | None = None):
    """t = (bin + u) * width + start per ray; (N,), (N,) -> (N, num).
    u = 0.5 without a generator (ref: layers/RaySamplePoint.py:87-102)."""
    n = t_start.shape[0]
    bins = torch.arange(num, dtype=t_start.dtype, device=t_start.device)[None]
    if generator is None:
        u = torch.full((n, num), 0.5, dtype=t_start.dtype, device=t_start.device)
    else:
        u = _uniform((n, num), t_start, generator)
    width = ((t_end - t_start) / num)[:, None]
    return (bins + u) * width + t_start[:, None]


def stratified_near_far(near: torch.Tensor, far: torch.Tensor, num: int,
                        generator: torch.Generator | None = None):
    """Linspace between near and far, jittered within neighbour midpoints
    when a generator is given (ref: layers/RaySamplePoint.py:179-195)."""
    t_vals = torch.linspace(0.0, 1.0, num, dtype=near.dtype,
                            device=near.device)[None]
    z = near[:, None] * (1.0 - t_vals) + far[:, None] * t_vals
    if generator is None:
        return z
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    upper = torch.cat([mids, z[:, -1:]], -1)
    lower = torch.cat([z[:, :1], mids], -1)
    return lower + (upper - lower) * _uniform(z.shape, near, generator)


def sample_pdf(z_vals: torch.Tensor, weights: torch.Tensor, num: int,
               generator: torch.Generator | None = None):
    """Inverse-CDF importance sampling (ref: utils/sample_pdf.py:18-63).

    z_vals (N, S), weights (N, S-2) interior weights -> (N, num) depths.
    """
    bins = 0.5 * (z_vals[:, 1:] + z_vals[:, :-1])                 # (N, S-1)
    w = weights + 1e-5
    pdf = w / w.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1).contiguous()
    if generator is None:
        u = torch.linspace(0.0, 1.0, num, dtype=z_vals.dtype,
                           device=z_vals.device).expand(cdf.shape[0], num)
    else:
        u = _uniform((cdf.shape[0], num), z_vals, generator)
    inds = torch.searchsorted(cdf, u.contiguous(), right=True)
    below = (inds - 1).clamp(min=0)
    above = inds.clamp(max=cdf.shape[-1] - 1)
    cdf_b, cdf_a = cdf.gather(-1, below), cdf.gather(-1, above)
    bins_b, bins_a = bins.gather(-1, below), bins.gather(-1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return bins_b + (u - cdf_b) / denom * (bins_a - bins_b)
