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


def _stream_cube(ts, a: int, b: int) -> torch.Tensor:
    """(N, S_a, S_b) 0/1: stream a's sample j precedes stream b's sample s
    (ties follow the stream order: ``<=`` for a < b, ``<`` for a > b)."""
    ta, tb = ts[a][:, :, None], ts[b][:, None, :]
    return (ta <= tb if a < b else ta < tb).to(ts[b].dtype)


class _CrossLogTStreams(torch.autograd.Function):
    """Per stream b: sum over the other streams a of their log factors at
    the samples preceding each of b's, ``cube[a][b]^T logf[a]``. The
    precedence cubes are temporaries of the forward and are rebuilt from
    the depths in the backward (the JAX package's ``jax.checkpoint``): the
    context keeps the depths only, never an (N, S_a, S_b) mask."""

    @staticmethod
    def forward(ctx, m: int, *tensors):
        ts, logfs = tensors[:m], tensors[m:]
        ctx.m = m
        ctx.save_for_backward(*ts)
        out = [torch.zeros_like(lf) for lf in logfs]
        for a in range(m):
            for b in range(m):
                if a != b:
                    out[b] += torch.einsum("njs,nj->ns", _stream_cube(ts, a, b), logfs[a])
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        ts = ctx.saved_tensors
        m = ctx.m
        d_logfs = [torch.zeros_like(t) for t in ts]
        for a in range(m):
            for b in range(m):
                if a != b:
                    d_logfs[a] += torch.einsum("njs,ns->nj", _stream_cube(ts, a, b), grads[b])
        return (None,) + (None,) * m + tuple(d_logfs)


def composite_streams_nosort(streams, boarder_weight: float = 1e10) -> RenderedRays:
    """Exact union compositing of several per-ray ascending sample streams
    without sorting their union (JAX ``ops/volume.py:159-262``): the
    training compositor of the fast fine stage, whose carried coarse and
    new importance streams differ in length.

    ``streams``: a sequence of ``(t (N, S_i), rgb (3, N, S_i), sigma (N,
    S_i))``, each stream's depths ascending per ray. Equal up to float
    reassociation to sorting the union and running
    :func:`volume_render_planar`. Each sample's union successor is the
    smallest later depth over all streams (``>`` from a stream before it,
    ``>=`` from one after it: ties follow the stream order); the "no
    successor" sentinel is the finite 3.4e38, whose ``isfinite`` test never
    picks ``boarder_weight`` (as JAX's). The exclusive transmittance is the
    exp of the stream's own log-factor cumsum plus the other streams' log
    factors at the samples that precede it (:class:`_CrossLogTStreams`,
    whose backward rebuilds the precedence masks); factors are floored at
    1e-10 before the log. Depths are constants (stop-gradient). ``weights``
    is the per-stream weights concatenated in stream order, (N, sum S_i,
    1)."""
    m = len(streams)
    ts = [s[0].detach() for s in streams]
    rgbs = [s[1] for s in streams]
    sigs = [s[2] for s in streams]
    n = ts[0].shape[0]
    nxt = [torch.cat([t[:, 1:], t.new_full((n, 1), 3.4e38)], -1) for t in ts]
    for a in range(m):
        for b in range(m):
            if a == b:
                continue
            ta, tb = ts[a][:, :, None], ts[b][:, None, :]
            after = ta >= tb if a > b else ta > tb
            nxt[b] = torch.minimum(nxt[b], torch.where(after, ta, 3.4e38).amin(1))
    deltas = [torch.where(torch.isfinite(x), x - t, boarder_weight)
              for x, t in zip(nxt, ts)]
    alphas = [1.0 - torch.exp(-torch.relu(sig) * d) for sig, d in zip(sigs, deltas)]
    logfs = [torch.log(torch.clamp(1.0 - al + 1e-10, min=1e-10)) for al in alphas]
    cross = _CrossLogTStreams.apply(m, *ts, *logfs)
    ws = [al * torch.exp(torch.cat([torch.zeros_like(lf[:, :1]),
                                    torch.cumsum(lf, -1)[:, :-1]], -1) + c)
          for al, lf, c in zip(alphas, logfs, cross)]
    color = sum((w[None] * torch.sigmoid(r)).sum(-1) for w, r in zip(ws, rgbs)).t()
    depth = sum((w * t).sum(-1) for w, t in zip(ws, ts))[:, None]
    acc = sum(w.sum(-1) for w in ws)[:, None]
    return RenderedRays(color, depth, acc, torch.cat(ws, -1)[..., None])


def composite_merged_nosort(t: torch.Tensor, rgb: torch.Tensor, sigma: torch.Tensor,
                            boarder_weight: float = 1e10,
                            kernel: bool = False) -> RenderedRays:
    """Merged-layer compositing without the cross-layer sort — the JAX
    package's training compositor (``ops/volume.py:263-353``), equal up to
    float reassociation to ``volume_render_planar(*merge_layers_planar(t,
    rgb, sigma))``.

    The union's exclusive transmittance at a sample factorizes into each
    stream's own product over the samples that precede it, so it is the exp
    of the stream's own exclusive log-factor cumsum plus a masked sum of
    the other streams' log factors; the union segment length runs to the
    nearest next sample in any stream. Depths are constants (stop-gradient).

    As the JAX package, the "no successor" sentinel is the finite 3.4e38:
    its ``isfinite`` test never picks ``boarder_weight``, and the last
    union sample gets delta ~ 3.4e38 - t. Factors are floored at 1e-10
    before the log.

    t (L, N, S) per-layer ascending depths, rgb (L, 3, N, S) raw, sigma
    (L, N, S) raw; ``weights`` is layer-major (N, L*S, 1). ``kernel`` takes
    the cross-stream terms from K4 and K5 (``kernels/cross_trans.py``: the
    kernels on CUDA tensors, their plain versions on CPU ones); otherwise
    from the plain cube forms, the JAX package's golden path.
    """
    from ..kernels import cross_trans

    L, N, S = t.shape
    t = t.detach()
    t_next_own = torch.cat([t[..., 1:], torch.full_like(t[..., :1], cross_trans.NO_SUCCESSOR)],
                           -1)
    succ = (cross_trans.cross_successor(t) if kernel
            else cross_trans.cross_successor_reference(t))
    nxt = torch.minimum(t_next_own, succ)
    delta = torch.where(torch.isfinite(nxt), nxt - t, boarder_weight).detach()
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * delta)
    f = 1.0 - alpha + 1e-10
    logf = torch.log(torch.clamp(f, min=1e-10))
    excl = torch.cat([torch.zeros_like(logf[..., :1]), torch.cumsum(logf, -1)[..., :-1]], -1)
    cross = (cross_trans.cross_log_transmittance(t, logf) if kernel
             else cross_trans.cross_log_transmittance_reference(t, logf))
    w = alpha * torch.exp(excl + cross)                          # (L, N, S)
    color = (w[:, None] * torch.sigmoid(rgb)).sum((0, 3)).t()
    depth = (w * t).sum((0, 2))[:, None]
    acc = w.sum((0, 2))[:, None]
    weights = w.permute(1, 0, 2).reshape(N, L * S)[..., None]
    return RenderedRays(color, depth, acc, weights)


def sort_samples_planar(t: torch.Tensor, rgb: torch.Tensor,
                        sigma: torch.Tensor):
    """Per-ray ascending depth sort carrying the samples' payload
    (``ops/volume.py:356-368``), for the fast fine stage's union of carried
    coarse and new importance samples: t (L, N, S), rgb (L, 3, N, S), sigma
    (L, N, S) -> the same shapes, each ray's samples in depth order. A
    stable sort and one gather per payload; at tied depths the order may
    differ from the JAX package's, the composite does not."""
    t_s, order = torch.sort(t, dim=-1, stable=True)
    rgb_s = rgb.gather(-1, order[:, None].expand(rgb.shape))
    return t_s, rgb_s, sigma.gather(-1, order)


def sort_merge_t(t_a: torch.Tensor, t_b: torch.Tensor) -> torch.Tensor:
    """Sorted union of two per-ray depth sets, (N,S1),(N,S2) -> (N,S1+S2)
    (ref: modeling/layered_rfrender.py:462)."""
    return torch.sort(torch.cat([t_a, t_b], -1), dim=-1).values
