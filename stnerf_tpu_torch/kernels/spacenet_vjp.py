"""SpaceNet forward and backward on encoded inputs — the port of
``stnerf_tpu/kernels/spacenet_vjp.py::spacenet_planar_trainable`` (K3).

The staged field path of a view-deforming model encodes the deformed
positions, the directions and the frame ids outside the kernel, so that
autograd carries the position-encoding gradient into the motion nets and
the direction-encoding gradient into the camera poses; the SpaceNet MLP
runs here. The pieces, as for every kernel of the port:

* :func:`spacenet_fwd` and :func:`spacenet_bwd` — the wrappers. On CUDA
  tensors they launch a hand-written kernel (built at first use by
  ``_build.py``) or raise: a bf16 field goes to the tensor-core kernels of
  ``csrc/spacenet_tc.cu``, a float32 one to the kernels of
  ``csrc/spacenet.cu`` (the backward's three passes planned by
  ``f32_bwd.make_plan``). On CPU tensors they run the plain versions.
* :func:`spacenet_fwd_reference` and :func:`spacenet_bwd_reference` — the
  plain PyTorch versions. The backward writes out the TPU kernel's
  ``_bwd_math`` (:func:`spacenet_bwd_math`, shared with the fused field's
  backward): activations rounded to the compute dtype, every cotangent
  rounded where the TPU kernel casts it, masks taken where the stored value
  is positive, weight gradients and d_pos/d_dir in float32. It is not
  autograd of the forward; a test holds the two equal in float32.
* ``spacenet_fwd.launches`` and ``spacenet_bwd.launches`` — how many times
  each wrapper launched a kernel, and ``launches_tc`` how many of those went
  to the tensor-core one.
* :func:`tc_workspace_bytes` — the device workspace the tensor-core
  backward allocates per call (its records and partial sums);
  :func:`float32_ring` and :func:`tc_launch` — a forward launch's sample
  block and shared memory (the float32 route's weight ring too); and
  :func:`tc_bwd_launch` — the tensor-core backward's pass-1 block (the
  float32 backward's is its plan's, ``f32_bwd.make_plan``). Both halves
  take widths up to 1024 (``fused_field.check_forward_widths``).
* ``active``: an optional (1,) int32 tensor on the inputs' device. Where it
  holds 0 the field is skipped, as the JAX path's chunk-level ``lax.cond``
  skips a hidden or missed performer: rgb and sigma are zeros, and so is
  every gradient. The kernels read it on the device (no host sync) and
  exit at once; the plain versions compute and then mask.
* :func:`spacenet_planar_trainable` — a ``torch.autograd.Function`` over a
  SpaceNet's ``nn.Linear`` parameters and the position and direction
  encodings. The time encoding gets no gradient.

Operands are the fused field's packing (``fused_field.pack_field`` without
a motion net). Layouts are the JAX kernel's: pos_enc (pos_dim, M), dir_enc
(dir_dim, M) or a (1, M) zero row without directions, time_enc (time_dim,
M) or None, all float32; outputs rgb (3, M) and sigma (M,) raw.
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING

import torch

from ..ops.rounding import round_to
from . import f32_bwd
from .fused_field import (PackedField, _check_taps, _field_linears, _linear_grads,
                          _workspace, check_forward_widths, pack_field,
                          prepare_kernel_params_planar, spacenet_chain)

if TYPE_CHECKING:  # models imports this module
    from ..models.spacenet import SpaceNet


def spacenet_fwd_reference(field: PackedField, pos_enc: torch.Tensor,
                           dir_enc: torch.Tensor,
                           time_enc: torch.Tensor | None = None,
                           active: torch.Tensor | None = None):
    """Plain PyTorch version of the forward kernel (``_fwd_kernel``).
    -> (rgb (3, M), sigma (M,)), raw; zeros where ``active`` is 0."""
    dt = field.dtype
    t_enc = round_to(time_enc, dt) if field.spec.use_time else None
    _, sigma, hs = spacenet_chain(field, round_to(pos_enc, dt),
                                  round_to(dir_enc, dt), t_enc)
    rgb, sigma = hs[-1], sigma[0]
    if active is not None:
        rgb, sigma = torch.where(active > 0, rgb, 0.0), torch.where(active > 0, sigma, 0.0)
    return rgb, sigma


def spacenet_bwd_math(field: PackedField, p: torch.Tensor, d_in: torch.Tensor,
                      t_enc: torch.Tensor | None, d_rgb: torch.Tensor,
                      d_sigma: torch.Tensor, product=torch.matmul):
    """The TPU kernels' ``_bwd_math`` on encodings rounded to the compute
    dtype: recompute the SpaceNet forward, backpropagate the cotangents
    d_rgb (3, M) and d_sigma (M,). -> ({weight slot: dW (in, out)}, {bias
    slot: db}, d_p (pos_dim, M), d_dir (dir_rows, M)), all float32. The
    backward's products (dx = W dy, dW = x dy^T) go through ``product``
    (``ops.rounding.tf32x3_matmul``: the float32 kernels' tensor-core
    arithmetic); the forward's stay float32 matmuls."""
    dt = field.dtype

    def r(x):
        return round_to(x, dt)

    def dx(slot, dy):       # d(input) = W dy, float32 accumulation
        return product(field.w(slot).float(), dy)

    def pos(x, dy):         # dy where the stored value x is positive
        return torch.where(x > 0, dy, 0.0)

    gws, gbs = {}, {}

    def grad(wslot, bslot, x, dy):
        gws[wslot] = product(x, dy.t())
        gbs[bslot] = dy.sum(1)

    relu = torch.relu
    a, _, hs = spacenet_chain(field, p, d_in, t_enc)
    # ---- rgb head ----
    dy = r(d_rgb)
    for i in reversed(range(field.n_rgb - 1)):
        grad(f"rgb{i + 1}", f"rgbb{i + 1}", hs[i], dy)
        dy = pos(hs[i], r(dx(f"rgb{i + 1}", dy)))
    gbs["rb1"] = dy.sum(1)
    gws["r1a"] = product(relu(a[6]), dy.t())
    gws["r1b"] = product(relu(d_in), dy.t())
    # through the head's leading ReLU: the POSE_REFINEMENT signal
    d_dir = pos(d_in, dx("r1b", dy))
    if t_enc is not None:
        gws["r1c"] = product(relu(t_enc), dy.t())
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
    gws["s2a"] = product(a[3], dy.t())
    gws["s2b"] = product(p, dy.t())
    gbs["sb1"] = dy.sum(1)
    d_p = dx("s2b", dy)                      # the skip path into the encoding
    dy = pos(a[3], r(dx("s2a", dy)))
    for k in (4, 3, 2):
        grad(f"w{k}", f"b{k}", a[k - 2], dy)
        dy = pos(a[k - 2], r(dx(f"w{k}", dy)))
    grad("w1", "b1", p, dy)
    return gws, gbs, dx("w1", dy) + d_p, d_dir


def pack_grads(field: PackedField, gws: dict, gbs: dict):
    """{slot: gradient} -> (gw, gb) float32 in the layout of the packed
    weights and biases; slots without a gradient stay zero."""
    device = field.weights.device
    gw = torch.zeros(field.weights.shape, dtype=torch.float32, device=device)
    gb = torch.zeros(field.biases.shape, dtype=torch.float32, device=device)
    for slot, g in gws.items():
        field.w(slot, gw).copy_(g)
    for slot, g in gbs.items():
        field.b(slot, gb).copy_(g)
    return gw, gb


def spacenet_bwd_reference(field: PackedField, pos_enc: torch.Tensor,
                           dir_enc: torch.Tensor, time_enc: torch.Tensor | None,
                           d_rgb: torch.Tensor, d_sigma: torch.Tensor,
                           active: torch.Tensor | None = None, product=torch.matmul):
    """Plain PyTorch version of the backward kernel (``_bwd_kernel``).
    -> (gw, gb, d_pos (pos_dim, M), d_dir (dir_rows, M)): gw and gb float32
    in the layout of ``field.weights`` and ``field.biases``; all zeros where
    ``active`` is 0 (the cotangents are masked). ``product``: as
    :func:`spacenet_bwd_math`'s."""
    dt = field.dtype
    if active is not None:
        d_rgb, d_sigma = torch.where(active > 0, d_rgb, 0.0), torch.where(active > 0, d_sigma, 0.0)
    t_enc = round_to(time_enc, dt) if field.spec.use_time else None
    gws, gbs, d_p, d_dir = spacenet_bwd_math(field, round_to(pos_enc, dt),
                                             round_to(dir_enc, dt), t_enc,
                                             d_rgb, d_sigma, product)
    return (*pack_grads(field, gws, gbs), d_p, d_dir)


def _check_inputs(field: PackedField, pos_enc, dir_enc, time_enc, active=None,
                  **cotangents):
    """Shapes, dtype, device and contiguity the kernels take. A time
    encoding is required with a time input and ignored without one."""
    if active is not None and (tuple(active.shape) != (1,) or active.dtype != torch.int32
                               or active.device != pos_enc.device):
        raise ValueError(f"active must be a (1,) int32 tensor on {pos_enc.device}, got "
                         f"{tuple(active.shape)} {active.dtype} on {active.device}")
    if field.motion_mode:
        raise ValueError("the SpaceNet kernel takes a field without a motion net")
    m = pos_enc.shape[-1]
    expect = {"pos_enc": (pos_enc, (field.shapes["w1"][0], m)),
              "dir_enc": (dir_enc, (field.shapes["r1b"][0], m))}
    if field.spec.use_time:
        if time_enc is None:
            raise ValueError("the field takes a time input: time_enc is missing")
        expect["time_enc"] = (time_enc, (field.shapes["r1c"][0], m))
    shapes = {"d_rgb": (3, m), "d_sigma": (m,)}
    expect.update({k: (t, shapes[k]) for k, t in cotangents.items()})
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != pos_enc.device:
            raise ValueError(f"{name} is on {t.device}, pos_enc on {pos_enc.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if field.weights.device != pos_enc.device:
        raise ValueError(f"field weights are on {field.weights.device}, "
                         f"inputs on {pos_enc.device}")


def _kernel_args(field: PackedField, pos_enc, dir_enc, time_enc, active) -> tuple:
    """The ints the entry points take after the pointers, the time pointer
    (null without a time input) and the active pointer (null without one),
    once the field's widths pass the kernels' check."""
    check_forward_widths([field.width, field.head])
    time_rows = time_enc.shape[0] if field.spec.use_time else 0
    ints = (pos_enc.shape[1], pos_enc.shape[0], dir_enc.shape[0], time_rows,
            field.width, field.head, field.n_rgb)
    return (ints, ctypes.c_void_p(time_enc.data_ptr() if time_rows else None),
            ctypes.c_void_p(None if active is None else active.data_ptr()))


def _launch_fwd(field: PackedField, pos_enc: torch.Tensor, dir_enc: torch.Tensor,
                time_enc: torch.Tensor | None, active: torch.Tensor | None,
                taps: torch.Tensor | None = None) -> torch.Tensor:
    """One launch of the forward kernel on checked CUDA inputs -> (4, M):
    raw rgb rows, then sigma. A bf16 field runs the tensor-core kernel, a
    float32 one the CUDA-core kernel. Counts nothing: :func:`counted_fwd`
    does. ``taps`` as :func:`spacenet_fwd`'s."""
    from ._build import load_library

    lib = load_library()
    ints, time_ptr, active_ptr = _kernel_args(field, pos_enc, dir_enc, time_enc, active)
    out = torch.empty((4, pos_enc.shape[1]), dtype=torch.float32, device=pos_enc.device)
    ptr = ctypes.c_void_p
    with torch.cuda.device(pos_enc.device):
        stream = ptr(torch.cuda.current_stream().cuda_stream)
        inputs = (ptr(pos_enc.data_ptr()), ptr(dir_enc.data_ptr()), time_ptr,
                  ptr(field.weights.data_ptr()))
        if field.compute_dtype == "bfloat16":
            frags, offsets = field.tc
            if taps is not None:
                taps = _workspace(taps, tc_launch(field, pos_enc, dir_enc, time_enc)["taps_bytes"],
                                  pos_enc.device)
            err = lib.stnerf_spacenet_fwd_tc(
                *inputs, ptr(frags.data_ptr()), ptr(field.biases.data_ptr()),
                ptr(field.tc_norms.data_ptr()), offsets.ctypes.data_as(ptr), active_ptr,
                ptr(out.data_ptr()), *ints, ptr(None if taps is None else taps.data_ptr()),
                stream)
        else:
            err = lib.stnerf_spacenet_fwd(
                *inputs, ptr(field.biases.data_ptr()), field.offsets.ctypes.data_as(ptr),
                active_ptr, ptr(out.data_ptr()), *ints, stream)
    if err != 0:
        raise RuntimeError(f"spacenet forward kernel launch failed: CUDA error {err}")
    return out


def tc_workspace_bytes(field: PackedField, pos_enc: torch.Tensor, dir_enc: torch.Tensor,
                       time_enc: torch.Tensor | None) -> int:
    """Bytes of device workspace the tensor-core backward allocates for
    these inputs: its records and partial sums (``csrc/spacenet_tc.cu``)."""
    from ._build import load_library

    ints = _kernel_args(field, pos_enc, dir_enc, time_enc, None)[0]
    nbytes = ctypes.c_int64()
    err = load_library().stnerf_spacenet_bwd_tc_workspace(
        *ints, field.weights.numel(), field.biases.numel(), ctypes.byref(nbytes))
    if err != 0:
        raise RuntimeError(f"spacenet backward workspace query failed: CUDA error {err}")
    return nbytes.value


def float32_ring(field: PackedField, pos_enc: torch.Tensor, dir_enc: torch.Tensor,
                 time_enc: torch.Tensor | None) -> dict:
    """The float32 forward kernel's launch for this field on these inputs
    (as K1's float32 route): its sample block, the weight ring's stages
    (``csrc/w_ring.cuh``), a stage's bytes and the block's dynamic shared
    memory. Needs the card."""
    from ._build import load_library

    out = (ctypes.c_int * 4)()
    ints = _kernel_args(field, pos_enc, dir_enc, time_enc, None)[0]
    err = load_library().stnerf_spacenet_ring(*ints, ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"spacenet ring query failed: CUDA error {err}")
    return {"stages": out[0], "stage_bytes": out[1], "smem_bytes": out[2],
            "block_samples": out[3]}


def tc_launch(field: PackedField, pos_enc: torch.Tensor, dir_enc: torch.Tensor,
              time_enc: torch.Tensor | None) -> dict:
    """The tensor-core forward kernel's launch for this bf16 field on these
    inputs (``csrc/spacenet_tc.cu``): its sample block, the block's dynamic
    shared memory, and the taps' rows a block and bytes (``spacenet_fwd``'s
    ``taps``). Needs the card."""
    from ._build import load_library

    out = (ctypes.c_int * 3)()
    ints = _kernel_args(field, pos_enc, dir_enc, time_enc, None)[0]
    err = load_library().stnerf_spacenet_fwd_tc_block(*ints, ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"spacenet_tc block query failed: CUDA error {err}")
    bm, rows = out[0], out[2]
    return {"block_samples": bm, "smem_bytes": out[1], "tap_rows": rows,
            "taps_bytes": -(-pos_enc.shape[1] // bm) * rows * bm * 2}


def tc_bwd_launch(field: PackedField, pos_enc: torch.Tensor, dir_enc: torch.Tensor,
                  time_enc: torch.Tensor | None) -> dict:
    """The tensor-core backward's launch for this bf16 field on these
    inputs (``csrc/spacenet_tc.cu``): pass 1's sample block and its dynamic
    shared memory. Needs the card."""
    from ._build import load_library

    out = (ctypes.c_int * 2)()
    ints = _kernel_args(field, pos_enc, dir_enc, time_enc, None)[0]
    err = load_library().stnerf_spacenet_bwd_tc_block(
        *ints, field.weights.numel(), field.biases.numel(), ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"spacenet_tc backward block query failed: CUDA error {err}")
    return {"block_samples": out[0], "smem_bytes": out[1]}


def _on_cuda(name: str, t: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; any other device raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {t.device}")
    return t.device.type == "cuda"


def counted_fwd(wrapper, field: PackedField, pos_enc: torch.Tensor,
                dir_enc: torch.Tensor, time_enc: torch.Tensor | None,
                active: torch.Tensor | None = None, taps: torch.Tensor | None = None):
    """The body of every wrapper of the forward kernel (``spacenet_fwd``
    and K6's entries): on CPU tensors the plain version; on CUDA tensors
    one launch, counted on ``wrapper.launches`` (and, on the tensor-core
    route, ``wrapper.launches_tc``). ``taps`` as :func:`spacenet_fwd`'s.
    -> (rgb (3, M), sigma (M,))."""
    _check_inputs(field, pos_enc, dir_enc, time_enc, active)
    _check_taps(taps, field.compute_dtype == "bfloat16", pos_enc.device, wrapper.__name__)
    if not _on_cuda(wrapper.__name__, pos_enc):
        return spacenet_fwd_reference(field, pos_enc, dir_enc, time_enc, active)
    out = _launch_fwd(field, pos_enc, dir_enc, time_enc, active, taps)
    wrapper.launches += 1
    wrapper.launches_tc += int(field.compute_dtype == "bfloat16")
    return out[:3], out[3]


def spacenet_fwd(field: PackedField, pos_enc: torch.Tensor, dir_enc: torch.Tensor,
                 time_enc: torch.Tensor | None = None, active: torch.Tensor | None = None, *,
                 taps: torch.Tensor | None = None):
    """SpaceNet forward on encoded inputs. -> (rgb (3, M), sigma (M,)), raw.

    CPU tensors run :func:`spacenet_fwd_reference`. CUDA tensors launch the
    tensor-core kernel for a bf16 field and the CUDA-core kernel for a
    float32 one, and any failure to build or launch it raises. The
    tensor-core kernel recomputes in float32 the outputs near a bf16
    rounding tie or 0 by the rule of its backward's recompute. ``taps``:
    for checks only, as ``fused_field.fused_field``'s (at least
    :func:`tc_launch`'s ``taps_bytes``); a CPU tensor and the float32 route
    refuse them.
    """
    return counted_fwd(spacenet_fwd, field, pos_enc, dir_enc, time_enc, active, taps)


spacenet_fwd.launches = 0
spacenet_fwd.launches_tc = 0


def spacenet_bwd(field: PackedField, pos_enc: torch.Tensor, dir_enc: torch.Tensor,
                 time_enc: torch.Tensor | None, d_rgb: torch.Tensor,
                 d_sigma: torch.Tensor, active: torch.Tensor | None = None, *,
                 workspace: torch.Tensor | None = None):
    """Backward of :func:`spacenet_fwd` at the same inputs, given the
    cotangents d_rgb (3, M) and d_sigma (M,) float32.
    -> (gw, gb, d_pos, d_dir) as :func:`spacenet_bwd_reference`.

    CPU tensors run :func:`spacenet_bwd_reference`. CUDA tensors launch the
    bf16 kernels for a bf16 field and the float32 ones for a float32 field
    (each three passes with a fixed-order sum: the same bits on every run),
    and any failure to build or launch them raises. ``workspace``: for
    checks only, as ``field_vjp.field_bwd``'s (at least
    :func:`tc_workspace_bytes`; pass 1's records stay in it).
    """
    _check_inputs(field, pos_enc, dir_enc, time_enc, active, d_rgb=d_rgb, d_sigma=d_sigma)
    if not _on_cuda("spacenet_bwd", pos_enc):
        return spacenet_bwd_reference(field, pos_enc, dir_enc, time_enc, d_rgb, d_sigma,
                                      active)
    from ._build import load_library

    lib = load_library()
    ints, time_ptr, active_ptr = _kernel_args(field, pos_enc, dir_enc, time_enc, active)
    dev = pos_enc.device
    # both routes' last pass writes every entry
    gw = torch.empty(field.weights.shape, dtype=torch.float32, device=dev)
    gb = torch.empty(field.biases.shape, dtype=torch.float32, device=dev)
    d_pos = torch.empty(tuple(pos_enc.shape), dtype=torch.float32, device=dev)
    d_dir = torch.empty(tuple(dir_enc.shape), dtype=torch.float32, device=dev)
    ptr = ctypes.c_void_p
    tc = field.compute_dtype == "bfloat16"
    outputs = (ptr(gw.data_ptr()), ptr(gb.data_ptr()), ptr(d_pos.data_ptr()),
               ptr(d_dir.data_ptr()))
    with torch.cuda.device(dev):
        stream = ptr(torch.cuda.current_stream().cuda_stream)
        inputs = (ptr(pos_enc.data_ptr()), ptr(dir_enc.data_ptr()), time_ptr,
                  ptr(d_rgb.data_ptr()), ptr(d_sigma.data_ptr()), ptr(field.weights.data_ptr()))
        if tc:
            frags, offsets = field.tc
            # the two-pass weight gradients' records and partial sums
            work = _workspace(workspace, tc_workspace_bytes(field, pos_enc, dir_enc, time_enc),
                              dev)
            err = lib.stnerf_spacenet_bwd_tc(
                *inputs, ptr(frags.data_ptr()), ptr(field.biases.data_ptr()),
                offsets.ctypes.data_as(ptr), active_ptr, *outputs, ptr(work.data_ptr()),
                *ints, field.weights.numel(), field.biases.numel(), stream)
        else:
            if workspace is not None:
                raise ValueError("spacenet_bwd takes a workspace on the bf16 route only")
            plan = f32_bwd.make_plan(field, pos_enc.shape[1], f32_bwd.sm_count(dev),
                                     f32_bwd.smem_optin(dev))
            # one slice's records and every range's partial sums
            work = torch.empty(plan.workspace_bytes, dtype=torch.uint8, device=dev)
            plan_ints = plan.array()
            err = lib.stnerf_spacenet_bwd(
                *inputs, ptr(field.dx_frags.data_ptr()), ptr(field.biases.data_ptr()),
                field.offsets.ctypes.data_as(ptr),
                plan_ints.ctypes.data_as(ptr), active_ptr, *outputs, ptr(work.data_ptr()),
                *ints, field.weights.numel(), field.biases.numel(), stream)
    if err != 0:
        raise RuntimeError(f"spacenet backward kernel launch failed: CUDA error {err}")
    spacenet_bwd.launches += 1
    spacenet_bwd.launches_tc += int(tc)
    return gw, gb, d_pos, d_dir


spacenet_bwd.launches = 0
spacenet_bwd.launches_tc = 0


# ---------------------------------------------------------------------------
# autograd over the nn.Linear parameters
# ---------------------------------------------------------------------------

class _TrainableSpaceNet(torch.autograd.Function):
    @staticmethod
    def forward(ctx, net, compute_dtype, plain, grad, pos_enc, dir_enc, time_enc, active,
                *params):
        dt = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
        field = pack_field(prepare_kernel_params_planar(net, dt), (), net.spec, None,
                           compute_dtype)
        if grad and not plain and pos_enc.device.type == "cuda":
            # before the forward launches
            check_forward_widths([field.width, field.head])
        evaluate = spacenet_fwd_reference if plain else spacenet_fwd
        rgb, sigma = evaluate(field, pos_enc, dir_enc, time_enc, active)
        ctx.field, ctx.plain = field, plain
        ctx.save_for_backward(pos_enc, dir_enc, time_enc, active)
        return rgb, sigma

    @staticmethod
    def backward(ctx, d_rgb, d_sigma):
        pos_enc, dir_enc, time_enc, active = ctx.saved_tensors
        backward = spacenet_bwd_reference if ctx.plain else spacenet_bwd
        gw, gb, d_pos, d_dir = backward(ctx.field, pos_enc, dir_enc, time_enc,
                                        d_rgb.contiguous(), d_sigma.contiguous(), active)
        grads = [g for pair in _linear_grads(ctx.field, gw, gb) for g in pair]
        need = ctx.needs_input_grad
        return (None, None, None, None, d_pos if need[4] else None,
                d_dir if need[5] else None, None, None, *grads)


def spacenet_planar_trainable(net: SpaceNet, pos_enc: torch.Tensor,
                              dir_enc: torch.Tensor,
                              time_enc: torch.Tensor | None = None,
                              compute_dtype: str = "bfloat16", plain: bool = False,
                              active: torch.Tensor | None = None):
    """Differentiable SpaceNet on pre-encoded planar inputs.

    pos_enc (pos_dim, M), dir_enc (dir_dim, M) (a (1, M) zero row without
    directions), time_enc (time_dim, M) or None, float32 and contiguous.
    -> (rgb (3, M), sigma (M,)), raw. Gradients flow to the linears of
    ``net``, to pos_enc and to dir_enc; time_enc gets none. ``plain`` runs
    the plain forward and backward whatever the device; otherwise CUDA
    tensors go through both kernels, and a field wider than the kernels
    take is refused before the forward launches when a gradient will be
    asked for (grad mode on, an input or a parameter requiring one).
    ``active`` (see the module docstring) skips the field on the device.
    """
    params = [p for layer in _field_linears(net, None) for p in (layer.weight, layer.bias)]
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (*params, pos_enc, dir_enc))
    return _TrainableSpaceNet.apply(net, compute_dtype, plain, grad, pos_enc, dir_enc,
                                    time_enc, active, *params)
