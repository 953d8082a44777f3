"""Cross-stream successor and log transmittance of the sort-free merged
compositor — the port of ``stnerf_tpu/kernels/cross_trans.py`` (K4
``cross_successor``, K5 ``cross_log_transmittance``).

``ops.volume.composite_merged_nosort`` composites L per-layer depth streams
(L, N, S) without sorting their union. Per ordered stream pair it needs the
precedence mask ``t[a,n,j] {<=,<} t[b,n,s]`` (``<=`` for a < b, ``<`` for
a > b: ties follow the stable stream order) twice: reduced against the log
transmittance factors (the cross-stream part of the exclusive log
transmittance) and to find each sample's cross-stream successor depth. The
pieces, as for every kernel of the port:

* :func:`cross_successor`, :func:`cross_log_transmittance_fwd` and
  :func:`cross_log_transmittance_bwd` — the wrappers. On CUDA tensors they
  launch ``csrc/cross_trans.cu`` (built at first use by ``_build.py``) or
  raise; on CPU tensors they run the plain versions.
* :func:`cross_successor_reference`,
  :func:`cross_log_transmittance_reference` and
  :func:`cross_log_transmittance_bwd_reference` — the plain PyTorch
  versions: the JAX package's cube form (``ops/volume.py:315-345``), one
  (N, S, S) precedence cube per ordered pair, the log-factor sum as an
  einsum, and autograd's transpose of it.
* ``.launches`` on each wrapper.
* :func:`cross_log_transmittance` — a ``torch.autograd.Function`` over the
  forward and backward kernels. Its context keeps only the depths: the
  backward rebuilds the masks from them. Depths get no gradient (they are
  compositing constants, as in the JAX package).

Shapes (L, N, S) float32 throughout; the successor is 3.4e38 where there is
none, the JAX package's finite sentinel.
"""

from __future__ import annotations

import ctypes

import torch

NO_SUCCESSOR = 3.4e38
_SHARED_BYTES = 48 * 1024  # csrc/cross_trans.cu: one ray's operands per block


def _cube(t: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """(N, S_a, S_b) bool: a's sample j precedes b's sample s."""
    ta, tb = t[a][:, :, None], t[b][:, None, :]
    return ta <= tb if a < b else ta < tb


def cross_successor_reference(t: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: per sample, the smallest depth of any other
    stream after it (``>`` for a < b, ``>=`` for a > b), 3.4e38 where none.
    t (L, N, S) -> (L, N, S)."""
    L = t.shape[0]
    inf = torch.tensor(NO_SUCCESSOR, dtype=t.dtype, device=t.device)
    out = []
    for b in range(L):
        nxt = torch.full_like(t[b], NO_SUCCESSOR)
        for a in range(L):
            if a == b:
                continue
            ta = t[a][:, :, None]
            above = torch.where(_cube(t, a, b), inf, ta) if a > b else \
                torch.where(ta > t[b][:, None, :], ta, inf)
            nxt = torch.minimum(nxt, above.min(1).values)
        out.append(nxt)
    return torch.stack(out)


def cross_log_transmittance_reference(t: torch.Tensor, logf: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: cross[b] = sum_{a != b} cube[a][b]^T logf[a], one
    einsum per ordered pair; differentiable in ``logf`` by autograd.
    (L, N, S) -> (L, N, S)."""
    L = t.shape[0]
    out = []
    for b in range(L):
        acc = torch.zeros_like(logf[b])
        for a in range(L):
            if a != b:
                acc = acc + torch.einsum("njs,nj->ns", _cube(t, a, b).float(), logf[a])
        out.append(acc)
    return torch.stack(out)


def cross_log_transmittance_bwd_reference(t: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of K5's backward: autograd's transpose of
    :func:`cross_log_transmittance_reference` applied to the cotangent g."""
    with torch.enable_grad():
        logf = torch.zeros_like(t, requires_grad=True)
        (d_logf,) = torch.autograd.grad(cross_log_transmittance_reference(t, logf), logf, g)
    return d_logf


def _check(name: str, **tensors):
    """The same (L, N, S) float32 contiguous shape on one cpu or cuda device."""
    ref = next(iter(tensors.values()))
    if ref.dim() != 3:
        raise ValueError(f"{name}: expected (L, N, S) tensors, got {tuple(ref.shape)}")
    for k, x in tensors.items():
        if tuple(x.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: {k} has shape {tuple(x.shape)}, expected "
                             f"{tuple(ref.shape)}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: {k} must be float32, got {x.dtype}")
        if x.device != ref.device:
            raise ValueError(f"{name}: {k} is on {x.device}, expected {ref.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
        if x.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")


def _launch(entry: str, out: torch.Tensor, *inputs: torch.Tensor) -> torch.Tensor:
    """One launch of ``entry`` on checked CUDA tensors, into ``out``."""
    from ._build import load_library

    L, N, S = out.shape
    need = 4 * len(inputs) * L * S
    if need > _SHARED_BYTES:
        raise ValueError(f"{entry}: one ray's L*S = {L * S} samples need {need} bytes of "
                         f"shared memory, the kernel takes at most {_SHARED_BYTES}")
    lib = load_library()
    ptr = ctypes.c_void_p
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(*(ptr(x.data_ptr()) for x in (*inputs, out)), L, N, S,
                                  ptr(stream))
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    return out


def cross_successor(t: torch.Tensor) -> torch.Tensor:
    """K4. t (L, N, S) float32 -> (L, N, S), no gradient.

    CPU tensors run :func:`cross_successor_reference`. CUDA tensors launch
    the kernel, and any failure to build or launch it raises."""
    _check("cross_successor", t=t)
    t = t.detach()
    if t.device.type == "cpu":
        return cross_successor_reference(t)
    out = _launch("stnerf_cross_successor", torch.empty_like(t), t)
    cross_successor.launches += 1
    return out


cross_successor.launches = 0


def cross_log_transmittance_fwd(t: torch.Tensor, logf: torch.Tensor) -> torch.Tensor:
    """K5's forward, outside autograd. -> cross (L, N, S).

    CPU tensors run :func:`cross_log_transmittance_reference`. CUDA tensors
    launch the kernel, and any failure to build or launch it raises."""
    _check("cross_log_transmittance_fwd", t=t, logf=logf)
    if t.device.type == "cpu":
        with torch.no_grad():
            return cross_log_transmittance_reference(t, logf)
    out = _launch("stnerf_cross_logt_fwd", torch.empty_like(t), t, logf)
    cross_log_transmittance_fwd.launches += 1
    return out


cross_log_transmittance_fwd.launches = 0


def cross_log_transmittance_bwd(t: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K5's backward: d_logf[a] = sum_{b != a} cube[a][b] g[b]. -> (L, N, S).

    CPU tensors run :func:`cross_log_transmittance_bwd_reference`. CUDA
    tensors launch the kernel, and any failure to build or launch it
    raises."""
    _check("cross_log_transmittance_bwd", t=t, g=g)
    if t.device.type == "cpu":
        return cross_log_transmittance_bwd_reference(t, g)
    out = _launch("stnerf_cross_logt_bwd", torch.empty_like(t), t, g)
    cross_log_transmittance_bwd.launches += 1
    return out


cross_log_transmittance_bwd.launches = 0


class _CrossLogTransmittance(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, logf):
        ctx.save_for_backward(t)
        return cross_log_transmittance_fwd(t, logf)

    @staticmethod
    def backward(ctx, g):
        (t,) = ctx.saved_tensors
        return None, cross_log_transmittance_bwd(t, g.contiguous())


def cross_log_transmittance(t: torch.Tensor, logf: torch.Tensor) -> torch.Tensor:
    """K5: cross[b,n,s] = sum_{a != b} sum_j [t[a,n,j] precedes t[b,n,s]]
    * logf[a,n,j], differentiable in ``logf`` (the backward is a kernel too
    on the card); ``t`` is a constant. (L, N, S) float32 -> (L, N, S)."""
    return _CrossLogTransmittance.apply(t.detach(), logf)
