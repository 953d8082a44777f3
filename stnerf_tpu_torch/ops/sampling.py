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


def stratified_union(t_near: torch.Tensor, t_far: torch.Tensor,
                     hit: torch.Tensor, num: int,
                     generator: torch.Generator | None = None):
    """Stratified samples over the union of K per-ray intervals, the
    occupancy gap skip (``ops/sampling.py:83-170``).

    t_near, t_far, hit (N, K): slice intervals in any order, overlapping or
    duplicated. -> t (N, num) ascending; a ray that hits no interval gets
    MISS_T. The intervals are union-merged (sorted by entry, each start
    clamped to the running max exit), the bins are laid over the merged
    length and mapped back to ray depths, so samples land only inside hit
    slices. With one contiguous union (slices that tile a box) this is
    :func:`stratified_between` over [min entry, max exit] up to rounding.
    """
    n, K = t_near.shape
    # misses park at a finite 1e30 entry / -1e30 exit: they sort to the
    # tail and merge to zero length (JAX's 3.4e38 rounded to inf in a bf16
    # gather there and poisoned the ray with 0 * inf)
    big = 1e30
    s_n, order = torch.sort(torch.where(hit, t_near, big), dim=1, stable=True)
    s_f = torch.where(hit, t_far, -big).gather(1, order)
    run_excl = torch.cat([torch.full_like(s_f[:, :1], -big),
                          torch.cummax(s_f, 1).values[:, :-1]], 1)
    eff_start = torch.maximum(s_n, run_excl)
    length = torch.clamp(s_f - eff_start, min=0.0)
    cum = torch.cumsum(length, 1)                            # (N, K) inclusive
    total = cum[:, -1:]
    bins = torch.arange(num, dtype=t_near.dtype, device=t_near.device)[None]
    if generator is None:
        u01 = torch.full((n, num), 0.5, dtype=t_near.dtype, device=t_near.device)
    else:
        u01 = _uniform((n, num), t_near, generator)
    # float32 rounds (bins + u01) / num up to exactly 1 for a last-bin draw
    # within ~2^-18 of 1, which would put u at the union's end; the clamp
    # keeps it strictly below (2^-20 >> the 2^-24 rounding step)
    u = torch.clamp((bins + u01) / num, max=1.0 - 2.0 ** -20) * total
    # the interval of each u: how many of the first K-1 ends lie at or below
    # it (zero-length merged intervals share an end with the one before)
    idx = torch.searchsorted(cum[:, :-1].contiguous(), u.contiguous(), right=True)
    cum_before = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], 1)
    off = torch.minimum(torch.clamp(u - cum_before.gather(1, idx), min=0.0),
                        length.gather(1, idx))
    t = eff_start.gather(1, idx) + off
    return torch.where(total > 0, t, MISS_T)


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
