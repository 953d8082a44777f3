"""The trainable fused field: forward through ``fused_field``, backward
through a hand-written kernel — the port of
``stnerf_tpu/kernels/field_vjp.py::field_planar_trainable``.

Three pieces beside the forward kernel's:

* :func:`field_bwd` — the wrapper of the backward. On a CUDA tensor it
  launches ``csrc/field_bwd.cu`` (built at first use by ``_build.py``) or
  raises; on a CPU tensor it runs the plain version.
* :func:`field_bwd_reference` — the plain PyTorch backward: the TPU kernel's
  ``_field_bwd_body`` written out (``spacenet_vjp._bwd_math``,
  ``_motion_bwd``, ``_encode_vjp``), with every cotangent rounded to the
  compute dtype where the TPU kernel casts it. It is not autograd of the
  forward; a test holds the two equal in float32.
* ``field_bwd.launches`` — how many times the wrapper launched the kernel.

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
                          _check_kernel_support, _encode, fused_field,
                          fused_field_reference, pack_field,
                          prepare_kernel_params_planar,
                          prepare_motion_params_planar)

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

    gws, gbs = {}, {}

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

    # ---- SpaceNet forward, keeping every activation (_fwd_chain) ----
    p32 = _encode(x_d, spec)
    p = r(p32)
    d_in = r(dir_enc)
    t_enc = r(_encode(ids, spec)) if spec.use_time else None
    a = [r(relu(mm("w1", p) + b("b1")))]
    for k in (2, 3, 4):
        a.append(r(relu(mm(f"w{k}", a[-1]) + b(f"b{k}"))))
    a.append(r(relu(mm("s2a", a[3]) + mm("s2b", p) + b("sb1"))))
    a.append(r(relu(mm("s2w2", a[4]) + b("sb2"))))
    a.append(r(relu(mm("s2w3", a[5]) + b("sb3"))))
    h0 = mm("r1a", relu(a[6])) + mm("r1b", relu(d_in))
    if spec.use_time:
        h0 = h0 + mm("r1c", relu(t_enc))
    hs = [r(relu(h0 + b("rb1")))]
    for i in range(field.n_rgb - 2):
        hs.append(r(relu(mm(f"rgb{i + 1}", hs[-1]) + b(f"rgbb{i + 1}"))))

    # ---- rgb head ----
    dy = r(d_rgb)
    for i in reversed(range(field.n_rgb - 1)):
        grad(f"rgb{i + 1}", f"rgbb{i + 1}", hs[i], dy)
        dy = pos(hs[i], r(dx(f"rgb{i + 1}", dy)))
    gbs["rb1"] = dy.sum(1)
    gws["r1a"] = relu(a[6]) @ dy.t()
    gws["r1b"] = relu(d_in) @ dy.t()
    d_dir = pos(d_in, dx("r1b", dy))
    if spec.use_time:
        gws["r1c"] = relu(t_enc) @ dy.t()
    d_a6 = pos(a[6], r(dx("r1a", dy)))
    # ---- density head ----
    ds = r(d_sigma[None])
    grad("dw", "db", a[6], ds)
    dy = pos(a[6], r(d_a6 + dx("dw", ds)))
    # ---- trunk ----
    grad("s2w3", "sb3", a[5], dy)
    dy = pos(a[5], r(dx("s2w3", dy)))
    grad("s2w2", "sb2", a[4], dy)
    dy = pos(a[4], r(dx("s2w2", dy)))
    gws["s2a"] = a[3] @ dy.t()
    gws["s2b"] = p @ dy.t()
    gbs["sb1"] = dy.sum(1)
    d_p = dx("s2b", dy)                      # the skip path into the encoding
    dy = pos(a[3], r(dx("s2a", dy)))
    for k in (4, 3, 2):
        grad(f"w{k}", f"b{k}", a[k - 2], dy)
        dy = pos(a[k - 2], r(dx(f"w{k}", dy)))
    grad("w1", "b1", p, dy)
    d_p = dx("w1", dy) + d_p
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
    gw = torch.zeros(field.weights.shape, dtype=torch.float32, device=xyz.device)
    gb = torch.zeros(field.biases.shape, dtype=torch.float32, device=xyz.device)
    for slot, g in gws.items():
        field.w(slot, gw).copy_(g)
    for slot, g in gbs.items():
        field.b(slot, gb).copy_(g)
    return gw, gb, d_xyz, d_dir


def field_bwd(field: PackedField, xyz: torch.Tensor, ids: torch.Tensor,
              dir_enc: torch.Tensor, d_rgb: torch.Tensor, d_sigma: torch.Tensor,
              tile_flags: torch.Tensor | None = None):
    """Backward of :func:`fused_field` at the same inputs, given the
    cotangents d_rgb (3, M) and d_sigma (M,) float32.
    -> (gw, gb, d_xyz, d_dir) as :func:`field_bwd_reference`.

    CPU tensors run :func:`field_bwd_reference`. CUDA tensors launch the
    kernel, and any failure to build or launch it raises.
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.stnerf_field_bwd(
            ptr(xyz.data_ptr()), ptr(ids.data_ptr()), ptr(dir_enc.data_ptr()),
            ptr(d_rgb.data_ptr()), ptr(d_sigma.data_ptr()),
            ptr(None if tile_flags is None else tile_flags.data_ptr()),
            ptr(field.weights.data_ptr()), ptr(field.biases.data_ptr()),
            field.offsets.ctypes.data_as(ptr), ptr(gw.data_ptr()),
            ptr(gb.data_ptr()), ptr(d_xyz.data_ptr()), ptr(d_dir.data_ptr()),
            m, dir_enc.shape[0], spec.backbone_dim, spec.head_dim,
            field.motion_width, spec.pos_freqs, int(spec.include_input),
            int(spec.use_time), field.n_rgb, MOTION_MODES[field.motion_mode],
            int(field.compute_dtype == "bfloat16"), ptr(stream))
    if err != 0:
        raise RuntimeError(f"field_bwd kernel launch failed: CUDA error {err}")
    field_bwd.launches += 1
    return gw, gb, d_xyz, d_dir


field_bwd.launches = 0


# ---------------------------------------------------------------------------
# autograd over the nn.Linear parameters
# ---------------------------------------------------------------------------

def _field_linears(net: SpaceNet, motion: MotionNet | None) -> list:
    """The field's linears in a fixed order: trunk, stage 2, density, rgb,
    then the motion net's."""
    layers = [*net.stage1, *net.stage2, *net.density, *net.rgb]
    return layers + (list(motion.net) if motion is not None else [])


def _linear_grads(field: PackedField, gw: torch.Tensor, gb: torch.Tensor) -> list:
    """Packed gradients -> [(d weight (out, in), d bias)] per linear of
    :func:`_field_linears`. The split first layers of stage 2 and of the rgb
    head are joined again; gradients of the (1, head) zero dummies that
    stand in for a missing direction or time input are dropped."""
    spec = field.spec

    def w(*parts):
        return torch.cat([field.w(s, gw) if isinstance(s, str) else s for s in parts],
                         0).t().contiguous()

    def b(slot):
        return field.b(slot, gb).clone()

    out = [(w(f"w{k}"), b(f"b{k}")) for k in (1, 2, 3, 4)]
    out += [(w("s2a", "s2b"), b("sb1")), (w("s2w2"), b("sb2")),
            (w("s2w3"), b("sb3")), (w("dw"), b("db"))]
    r1 = ["r1a"]
    if spec.dir_dim:
        r1.append(field.w("r1b", gw)[:spec.dir_dim])
    if spec.time_dim:
        r1.append(field.w("r1c", gw)[:spec.time_dim])
    out.append((w(*r1), b("rb1")))
    out += [(w(f"rgb{i}"), b(f"rgbb{i}")) for i in range(1, field.n_rgb)]
    if field.motion_mode:
        out += [(w(f"m{k}"), b(f"mb{k}")) for k in range(6)]
    return out


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
