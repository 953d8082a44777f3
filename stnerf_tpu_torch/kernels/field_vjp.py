"""The trainable fused field: forward through ``fused_field``, backward
through a hand-written kernel — the port of
``stnerf_tpu/kernels/field_vjp.py::field_planar_trainable``.

Three pieces beside the forward kernel's:

* :func:`field_bwd` — the wrapper of the backward. On a CUDA tensor it
  launches a hand-written kernel (built at first use by ``_build.py``) or
  raises: a bf16 field goes to the tensor-core kernel
  ``csrc/field_bwd_tc.cu``, a float32 one to the CUDA-core kernel
  ``csrc/field_bwd.cu``. On a CPU tensor it runs the plain version.
* :func:`field_bwd_reference` — the plain PyTorch backward: the TPU kernel's
  ``_field_bwd_body`` written out (``_bwd_math``, shared with
  ``spacenet_vjp.py``; ``_motion_bwd``; ``_encode_vjp``), with every
  cotangent rounded to the compute dtype where the TPU kernel casts it. It
  is not autograd of the forward; a test holds the two equal in float32.
* ``field_bwd.launches`` — how many times the wrapper launched a kernel, and
  ``field_bwd.launches_tc`` how many of those went to the tensor-core one.

Both return the gradients in the packed layout of :class:`PackedField`
(weights and biases float32, at the packed offsets), plus d_xyz (3, M) and
d_dir_enc (dir_rows, M). :func:`field_planar_trainable` wraps forward and
backward in a ``torch.autograd.Function`` over a SpaceNet's and a
MotionNet's ``nn.Linear`` parameters and maps the packed gradients back to
them.
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING

import torch

from ..ops.rounding import round_to
from .fused_field import (MOTION_MODES, TILE, PackedField, _check_inputs,
                          _check_kernel_support, _encode, _field_linears,
                          _linear_grads, fused_field, fused_field_reference,
                          pack_field, prepare_kernel_params_planar,
                          prepare_motion_params_planar)
from .spacenet_vjp import pack_grads, spacenet_bwd_math

if TYPE_CHECKING:  # models imports this module
    from ..models.motionnet import MotionNet
    from ..models.spacenet import SpaceNet


def _encode_vjp(enc: torch.Tensor, d_enc: torch.Tensor, c: int, freqs: int,
                inc: bool) -> torch.Tensor:
    """VJP of the double-angle encoding wrt its raw (c, M) input; ``enc``
    is the forward encoding, whose sin/cos rows are the derivative factors
    (``field_vjp.py:47-63``)."""
    off = c if inc else 0
    d_v = d_enc[:c] if inc else torch.zeros_like(d_enc[:c])
    scale = 1.0
    for k in range(freqs):
        s = enc[off + 2 * k * c: off + (2 * k + 1) * c]
        co = enc[off + (2 * k + 1) * c: off + (2 * k + 2) * c]
        ds = d_enc[off + 2 * k * c: off + (2 * k + 1) * c]
        dc = d_enc[off + (2 * k + 1) * c: off + (2 * k + 2) * c]
        d_v = d_v + scale * (co * ds - s * dc)
        scale *= 2.0
    return d_v


def field_bwd_reference(field: PackedField, xyz: torch.Tensor, ids: torch.Tensor,
                        dir_enc: torch.Tensor, d_rgb: torch.Tensor,
                        d_sigma: torch.Tensor,
                        tile_flags: torch.Tensor | None = None):
    """Plain PyTorch version of the backward kernel.

    -> (gw, gb, d_xyz (3, M), d_dir (dir_rows, M)): gw and gb float32 with
    the layout of ``field.weights`` and ``field.biases``. A skipped tile
    adds nothing and gets zero d_xyz and d_dir. Weight and bias gradients
    are summed in float32.
    """
    dt = field.dtype
    spec = field.spec
    freqs, inc = spec.pos_freqs, spec.include_input
    m = xyz.shape[1]

    def r(x):
        return round_to(x, dt)

    def mm(slot, x):        # y = W^T x
        return field.w(slot).float().t() @ x

    def b(slot):
        return field.b(slot)[:, None]

    def dx(slot, dy):       # d(input) = W dy, float32 accumulation
        return field.w(slot).float() @ dy

    def pos(x, dy):         # dy where the activation x is positive
        return torch.where(x > 0, dy, 0.0)

    def grad(wslot, bslot, x, dy):
        gws[wslot] = x @ dy.t()
        gbs[bslot] = dy.sum(1)

    keep = None
    if tile_flags is not None:
        keep = (tile_flags != 0).repeat_interleave(TILE)[:m]
        d_rgb = torch.where(keep, d_rgb, 0.0)
        d_sigma = torch.where(keep, d_sigma, 0.0)
    relu = torch.relu

    # ---- recompute the deformation ----
    if field.motion_mode:
        if field.motion_mode == "lerp":
            lo = torch.floor(ids)
            w = ids - lo
            e_lo = _encode(torch.cat([xyz, lo], 0), spec)
            e_hi = _encode(torch.cat([xyz, lo + 1.0], 0), spec)
            enc_m = (1.0 - w) * e_lo + w * e_hi
        else:
            enc_m = _encode(torch.cat([xyz, ids], 0), spec)
        m_acts = [r(enc_m)]
        h = m_acts[0]
        for k in range(6):
            h = mm(f"m{k}", h) + b(f"mb{k}")
            if k < 5:
                h = r(relu(h))
                m_acts.append(h)
        x_d = xyz + h
    else:
        x_d = xyz

    # ---- the SpaceNet backward on the encodings (_bwd_math) ----
    p32 = _encode(x_d, spec)
    t_enc = r(_encode(ids, spec)) if spec.use_time else None
    gws, gbs, d_p, d_dir = spacenet_bwd_math(field, r(p32), r(dir_enc), t_enc,
                                             d_rgb, d_sigma)
    d_xyz = _encode_vjp(p32, d_p, 3, freqs, inc)

    # ---- motion net ----
    if field.motion_mode:
        dy = r(d_xyz)
        for k in reversed(range(6)):
            grad(f"m{k}", f"mb{k}", m_acts[k], dy)
            dy = dx(f"m{k}", dy)
            if k > 0:
                dy = pos(m_acts[k], r(dy))
        if field.motion_mode == "lerp":  # the blend weight is not differentiated
            d_xyz_m = (_encode_vjp(e_lo, (1.0 - w) * dy, 4, freqs, inc)[:3]
                       + _encode_vjp(e_hi, w * dy, 4, freqs, inc)[:3])
        else:
            d_xyz_m = _encode_vjp(enc_m, dy, 4, freqs, inc)[:3]
        d_xyz = d_xyz + d_xyz_m

    if keep is not None:
        d_xyz = torch.where(keep, d_xyz, 0.0)
        d_dir = torch.where(keep, d_dir, 0.0)
    return (*pack_grads(field, gws, gbs), d_xyz, d_dir)


def field_bwd(field: PackedField, xyz: torch.Tensor, ids: torch.Tensor,
              dir_enc: torch.Tensor, d_rgb: torch.Tensor, d_sigma: torch.Tensor,
              tile_flags: torch.Tensor | None = None):
    """Backward of :func:`fused_field` at the same inputs, given the
    cotangents d_rgb (3, M) and d_sigma (M,) float32.
    -> (gw, gb, d_xyz, d_dir) as :func:`field_bwd_reference`.

    CPU tensors run :func:`field_bwd_reference`. CUDA tensors launch the
    tensor-core kernel for a bf16 field and the CUDA-core kernel for a
    float32 one, and any failure to build or launch it raises.
    """
    _check_inputs(field, xyz, ids, dir_enc, tile_flags)
    m = xyz.shape[1]
    for name, t, shape in (("d_rgb", d_rgb, (3, m)), ("d_sigma", d_sigma, (m,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != xyz.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous, on the inputs' device")
    if xyz.device.type == "cpu":
        return field_bwd_reference(field, xyz, ids, dir_enc, d_rgb, d_sigma, tile_flags)
    if xyz.device.type != "cuda":
        raise ValueError(f"field_bwd runs on cpu or cuda, not {xyz.device}")
    _check_kernel_support(field)
    from ._build import load_library

    lib = load_library()
    dev = xyz.device
    gw = torch.zeros(field.weights.shape, dtype=torch.float32, device=dev)
    gb = torch.zeros(field.biases.shape, dtype=torch.float32, device=dev)
    d_xyz = torch.empty((3, m), dtype=torch.float32, device=dev)
    d_dir = torch.empty(tuple(dir_enc.shape), dtype=torch.float32, device=dev)
    spec = field.spec
    ptr = ctypes.c_void_p
    tc = field.compute_dtype == "bfloat16"
    ints = (m, dir_enc.shape[0], spec.backbone_dim, spec.head_dim, field.motion_width,
            spec.pos_freqs, int(spec.include_input), int(spec.use_time), field.n_rgb,
            MOTION_MODES[field.motion_mode])
    outputs = (ptr(gw.data_ptr()), ptr(gb.data_ptr()), ptr(d_xyz.data_ptr()),
               ptr(d_dir.data_ptr()))
    with torch.cuda.device(dev):
        stream = ptr(torch.cuda.current_stream().cuda_stream)
        inputs = (ptr(xyz.data_ptr()), ptr(ids.data_ptr()), ptr(dir_enc.data_ptr()),
                  ptr(d_rgb.data_ptr()), ptr(d_sigma.data_ptr()),
                  ptr(None if tile_flags is None else tile_flags.data_ptr()),
                  ptr(field.weights.data_ptr()))
        if tc:
            frags, offsets = field.tc
            counts = (field.weights.numel(), field.biases.numel())
            nbytes = ctypes.c_int64()
            err = lib.stnerf_field_bwd_tc_workspace(*ints, *counts, ctypes.byref(nbytes))
            if err == 0:
                # the two-pass weight gradients' records and partial sums
                work = torch.empty(nbytes.value, dtype=torch.uint8, device=dev)
                err = lib.stnerf_field_bwd_tc(
                    *inputs, ptr(frags.data_ptr()), ptr(field.biases.data_ptr()),
                    offsets.ctypes.data_as(ptr), *outputs, ptr(work.data_ptr()), *ints,
                    *counts, stream)
        else:
            err = lib.stnerf_field_bwd(
                *inputs, ptr(field.biases.data_ptr()), field.offsets.ctypes.data_as(ptr),
                *outputs, *ints, stream)
    if err != 0:
        raise RuntimeError(f"field_bwd kernel launch failed: CUDA error {err}")
    field_bwd.launches += 1
    field_bwd.launches_tc += int(tc)
    return gw, gb, d_xyz, d_dir


field_bwd.launches = 0
field_bwd.launches_tc = 0


# ---------------------------------------------------------------------------
# autograd over the nn.Linear parameters
# ---------------------------------------------------------------------------

class _TrainableField(torch.autograd.Function):
    @staticmethod
    def forward(ctx, net, motion, motion_mode, compute_dtype, plain, xyz, ids,
                dir_enc, tile_flags, *params):
        dt = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
        field = pack_field(prepare_kernel_params_planar(net, dt),
                           prepare_motion_params_planar(motion, dt) if motion_mode else (),
                           net.spec, motion_mode, compute_dtype)
        evaluate = fused_field_reference if plain else fused_field
        rgb, sigma = evaluate(field, xyz, ids, dir_enc, tile_flags)
        ctx.field, ctx.plain = field, plain
        ctx.save_for_backward(xyz, ids, dir_enc, tile_flags)
        return rgb, sigma

    @staticmethod
    def backward(ctx, d_rgb, d_sigma):
        xyz, ids, dir_enc, tile_flags = ctx.saved_tensors
        backward = field_bwd_reference if ctx.plain else field_bwd
        gw, gb, d_xyz, d_dir = backward(ctx.field, xyz, ids, dir_enc,
                                        d_rgb.contiguous(), d_sigma.contiguous(),
                                        tile_flags)
        grads = [g for pair in _linear_grads(ctx.field, gw, gb) for g in pair]
        need = ctx.needs_input_grad
        return (None, None, None, None, None,
                d_xyz if need[5] else None, None,
                d_dir if need[7] else None, None, *grads)


def field_planar_trainable(net: SpaceNet, motion: MotionNet | None,
                           xyz: torch.Tensor, ids: torch.Tensor,
                           dir_enc: torch.Tensor,
                           tile_flags: torch.Tensor | None = None,
                           motion_mode: str | None = None,
                           compute_dtype: str = "bfloat16", plain: bool = False):
    """Differentiable fused field on raw planar positions.

    xyz (3, M) canonical pre-deformation positions, ids (1, M) frame ids
    (never differentiated), dir_enc (dir_dim, M) direction encoding (a
    (1, M) zero row without directions), tile_flags as :func:`fused_field`'s.
    -> (rgb (3, M), sigma (M,)), raw. Gradients flow to the linears of
    ``net`` and ``motion`` (with ``motion_mode`` "direct" or "lerp"), to xyz
    and to dir_enc. ``plain`` runs the plain forward and backward whatever
    the device; otherwise CUDA tensors go through both kernels.
    """
    if motion_mode and motion is None:
        raise ValueError(f"motion_mode {motion_mode!r} needs a motion net")
    params = [p for layer in _field_linears(net, motion if motion_mode else None)
              for p in (layer.weight, layer.bias)]
    return _TrainableField.apply(net, motion, motion_mode, compute_dtype, plain,
                                 xyz, ids, dir_enc, tile_flags, *params)
