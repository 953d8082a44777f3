"""Fused field evaluation: MotionNet displacement, positional encodings and
the SpaceNet MLP in one kernel — the port of
``stnerf_tpu/kernels/fused_field.py::fused_field``.

Three pieces, as for every kernel of the port:

* :func:`fused_field` — the wrapper. On a CUDA tensor it launches the
  hand-written kernel in ``csrc/fused_field.cu`` (built at first use by
  ``_build.py``) or raises; on a CPU tensor it runs the plain version.
* :func:`fused_field_reference` — the plain PyTorch version: the same math
  on the same packed operands, with the kernel's double-angle encoding and
  its per-layer rounding to the compute dtype.
* ``fused_field.launches`` — how many times the wrapper launched the kernel.

Layouts are the JAX kernel's: xyz (3, M), ids (1, M), dir_enc (dir_dim, M),
optional int32 per-tile skip flags, outputs rgb (3, M) and sigma (M,) raw.
Weights are (in, out) in the compute dtype, biases float32. The JAX
signature's (space_kparams, motion_kparams, spec, motion_mode,
compute_dtype) are bundled once per field by :func:`pack_field` into one
weight buffer, one bias buffer and an offset table, so the kernel takes a
handful of pointers.

A skip flag covers :data:`TILE` consecutive samples (one CUDA block); a
tile whose flag is 0 comes out as exact zeros.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import TYPE_CHECKING

import numpy as np
import torch

from ..ops.encoding import positional_encoding_planar
from ..ops.rounding import round_to

if TYPE_CHECKING:  # models imports this module
    from ..models.motionnet import MotionNet
    from ..models.spacenet import SpaceNet, SpaceNetSpec

TILE = 64  # samples per CUDA block = granularity of the skip flags

MOTION_MODES = {None: 0, "direct": 1, "lerp": 2}
KERNEL_WIDTHS = (32, 64, 128, 256)  # layer widths the kernel's tiling takes

# operand slots of the packed buffers, in csrc/fused_field.cu's order
W_SLOTS = ("m0", "m1", "m2", "m3", "m4", "m5", "w1", "w2", "w3", "w4",
           "s2a", "s2b", "s2w2", "s2w3", "dw", "r1a", "r1b", "r1c",
           "rgb1", "rgb2", "rgb3")
B_SLOTS = ("mb0", "mb1", "mb2", "mb3", "mb4", "mb5", "b1", "b2", "b3", "b4",
           "sb1", "sb2", "sb3", "db", "rb1", "rgbb1", "rgbb2", "rgbb3")
_SPACE_ORDER = ("w1", "b1", "w2", "b2", "w3", "b3", "w4", "b4",
                "s2a", "s2b", "sb1", "s2w2", "sb2", "s2w3", "sb3",
                "dw", "db", "r1a", "r1b", "r1c", "rb1")
_ALIGN = 16  # elements: every operand starts 32-byte aligned in bf16


def _wt(layer, dtype):
    return layer.weight.detach().t().to(dtype).contiguous()


def _bias(layer):
    return layer.bias.detach().float()[:, None]


def prepare_kernel_params_planar(net: SpaceNet, dtype=torch.bfloat16) -> tuple:
    """SpaceNet -> the JAX kernel's operand tuple
    (``fused_spacenet.prepare_kernel_params_planar``): weights (in, out) in
    ``dtype``, biases (out, 1) float32, the stage-2 and rgb first layers
    split at their concat boundaries, and a (1, head) zero dummy where the
    net has no direction or time input."""
    spec = net.spec
    W, H = spec.backbone_dim, spec.head_dim
    s2w = _wt(net.stage2[0], dtype)
    r1 = _wt(net.rgb[0], dtype)
    dummy = torch.zeros((1, H), dtype=dtype, device=r1.device)
    d_dim, t_dim = spec.dir_dim, spec.time_dim
    ops = []
    for layer in net.stage1:
        ops += [_wt(layer, dtype), _bias(layer)]
    ops += [s2w[:W], s2w[W:], _bias(net.stage2[0])]
    for layer in net.stage2[1:]:
        ops += [_wt(layer, dtype), _bias(layer)]
    ops += [_wt(net.density[0], dtype), _bias(net.density[0]),
            r1[:W], r1[W:W + d_dim] if d_dim else dummy,
            r1[W + d_dim:W + d_dim + t_dim] if t_dim else dummy,
            _bias(net.rgb[0])]
    for layer in net.rgb[1:]:
        ops += [_wt(layer, dtype), _bias(layer)]
    return tuple(ops)


def prepare_motion_params_planar(net: MotionNet, dtype=torch.bfloat16) -> tuple:
    """MotionNet -> (w (in, out), b (out, 1)) x 6."""
    ops = []
    for layer in net.net:
        ops += [_wt(layer, dtype), _bias(layer)]
    return tuple(ops)


@dataclasses.dataclass(frozen=True, eq=False)
class PackedField:
    """One field's kernel operands in two flat buffers."""
    weights: torch.Tensor        # 1-D, compute dtype
    biases: torch.Tensor         # 1-D float32
    offsets: np.ndarray          # int32 [len(W_SLOTS) + len(B_SLOTS)], -1 = absent
    shapes: dict                 # slot -> (in, out) or (out,)
    spec: SpaceNetSpec
    motion_mode: str | None
    motion_width: int
    compute_dtype: str

    @property
    def dtype(self):
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    @property
    def n_rgb(self) -> int:
        return 4 if self.spec.deep_rgb else 2

    def w(self, slot: str, buf: torch.Tensor | None = None) -> torch.Tensor:
        """Weight ``slot`` (in, out), viewed in the packed weights or in a
        buffer of the same layout (the backward's weight gradients)."""
        k_in, k_out = self.shapes[slot]
        off = int(self.offsets[W_SLOTS.index(slot)])
        buf = self.weights if buf is None else buf
        return buf[off:off + k_in * k_out].view(k_in, k_out)

    def b(self, slot: str, buf: torch.Tensor | None = None) -> torch.Tensor:
        (n,) = self.shapes[slot]
        off = int(self.offsets[len(W_SLOTS) + B_SLOTS.index(slot)])
        buf = self.biases if buf is None else buf
        return buf[off:off + n]


def pack_field(space_ops: tuple, motion_ops: tuple, spec: SpaceNetSpec,
               motion_mode: str | None = None,
               compute_dtype: str = "bfloat16") -> PackedField:
    """Pack the operand tuples of :func:`prepare_kernel_params_planar` and
    :func:`prepare_motion_params_planar` once per field."""
    if motion_mode not in MOTION_MODES:
        raise ValueError(f"motion_mode must be one of {list(MOTION_MODES)}")
    named = dict(zip(_SPACE_ORDER, space_ops))
    rest = space_ops[len(_SPACE_ORDER):]
    for i in range(len(rest) // 2):
        named[f"rgb{i + 1}"], named[f"rgbb{i + 1}"] = rest[2 * i], rest[2 * i + 1]
    if motion_mode:
        for k in range(6):
            named[f"m{k}"], named[f"mb{k}"] = motion_ops[2 * k], motion_ops[2 * k + 1]
    dtype = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32

    def layout(slots):
        offs, total = [], 0
        for s in slots:
            if s in named:
                offs.append(total)
                total += -(-named[s].numel() // _ALIGN) * _ALIGN
            else:
                offs.append(-1)
        return offs, total

    w_offs, w_total = layout(W_SLOTS)
    b_offs, b_total = layout(B_SLOTS)
    device = named["w1"].device
    weights = torch.zeros(w_total, dtype=dtype, device=device)
    biases = torch.zeros(b_total, dtype=torch.float32, device=device)
    shapes = {}
    for slots, offs, buf in ((W_SLOTS, w_offs, weights), (B_SLOTS, b_offs, biases)):
        for s, off in zip(slots, offs):
            if off < 0:
                continue
            t = named[s]
            if buf is biases:
                t = t.reshape(-1)
            shapes[s] = tuple(t.shape)
            buf[off:off + t.numel()] = t.reshape(-1).to(buf.dtype)
    motion_width = named["m0"].shape[1] if motion_mode else 0
    return PackedField(weights, biases,
                       np.asarray(w_offs + b_offs, np.int32), shapes, spec,
                       motion_mode, motion_width, compute_dtype)


def _encode(v: torch.Tensor, spec: SpaceNetSpec) -> torch.Tensor:
    """The kernel's encoding: double-angle recursion, pos_freqs octaves for
    every input (``fused_field.py:43-56``)."""
    return positional_encoding_planar(v, spec.pos_freqs, spec.include_input,
                                      recursive=True)


def fused_field_reference(field: PackedField, xyz: torch.Tensor,
                          ids: torch.Tensor, dir_enc: torch.Tensor,
                          tile_flags: torch.Tensor | None = None):
    """Plain PyTorch version of the kernel: same operands, same math
    (``_kernel_body``, ``fused_field.py:78-131``). -> (rgb (3, M), sigma (M,))."""
    dt = field.dtype
    spec = field.spec

    def r(x):
        return round_to(x, dt)

    def mm(slot, x):
        return field.w(slot).float().t() @ x

    def b(slot):
        return field.b(slot)[:, None]

    relu = torch.relu
    if field.motion_mode:
        if field.motion_mode == "lerp":
            lo = torch.floor(ids)
            w = ids - lo
            enc = ((1.0 - w) * _encode(torch.cat([xyz, lo], 0), spec)
                   + w * _encode(torch.cat([xyz, lo + 1.0], 0), spec))
        else:
            enc = _encode(torch.cat([xyz, ids], 0), spec)
        h = r(enc)
        for k in range(6):
            h = mm(f"m{k}", h) + b(f"mb{k}")
            if k < 5:
                h = r(relu(h))
        xyz = xyz + h

    p = r(_encode(xyz, spec))
    x = r(relu(mm("w1", p) + b("b1")))
    x = r(relu(mm("w2", x) + b("b2")))
    x = r(relu(mm("w3", x) + b("b3")))
    x = r(relu(mm("w4", x) + b("b4")))
    x = r(relu(mm("s2a", x) + mm("s2b", p) + b("sb1")))
    x = r(relu(mm("s2w2", x) + b("sb2")))
    x = r(relu(mm("s2w3", x) + b("sb3")))
    sigma = mm("dw", x) + b("db")

    h = mm("r1a", relu(x)) + mm("r1b", relu(r(dir_enc)))
    if spec.use_time:
        h = h + mm("r1c", relu(r(_encode(ids, spec))))
    h = r(relu(h + b("rb1")))
    for i in range(field.n_rgb - 1):
        h = mm(f"rgb{i + 1}", h) + b(f"rgbb{i + 1}")
        if i < field.n_rgb - 2:
            h = r(relu(h))
    rgb, sigma = h, sigma[0]
    if tile_flags is not None:
        keep = (tile_flags != 0).repeat_interleave(TILE)[:xyz.shape[1]]
        rgb = torch.where(keep, rgb, 0.0)
        sigma = torch.where(keep, sigma, 0.0)
    return rgb, sigma


def _check_inputs(field: PackedField, xyz, ids, dir_enc, tile_flags):
    m = xyz.shape[-1]
    expect = {"xyz": (xyz, (3, m)), "ids": (ids, (1, m)),
              "dir_enc": (dir_enc, (field.shapes["r1b"][0], m))}
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != xyz.device:
            raise ValueError(f"{name} is on {t.device}, xyz on {xyz.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if field.weights.device != xyz.device:
        raise ValueError(f"field weights are on {field.weights.device}, "
                         f"inputs on {xyz.device}")
    if tile_flags is not None:
        n_tiles = -(-m // TILE)
        if tuple(tile_flags.shape) != (n_tiles,) or tile_flags.dtype != torch.int32:
            raise ValueError(f"tile_flags must be int32 of shape ({n_tiles},), got "
                             f"{tile_flags.dtype} {tuple(tile_flags.shape)}")
        if tile_flags.device != xyz.device or not tile_flags.is_contiguous():
            raise ValueError("tile_flags must be contiguous, on the inputs' device")


def _check_kernel_support(field: PackedField):
    spec = field.spec
    widths = [spec.backbone_dim, spec.head_dim] + (
        [field.motion_width] if field.motion_mode else [])
    if any(w not in KERNEL_WIDTHS for w in widths):
        raise ValueError(f"the CUDA kernel takes layer widths {KERNEL_WIDTHS}, "
                         f"got {widths}")
    if spec.use_time and spec.time_freqs != spec.pos_freqs:
        raise ValueError("the kernel encodes time with pos_freqs octaves")


def fused_field(field: PackedField, xyz: torch.Tensor, ids: torch.Tensor,
                dir_enc: torch.Tensor, tile_flags: torch.Tensor | None = None):
    """Evaluate one (optionally deformed) radiance field.

    xyz (3, M) canonical positions, ids (1, M) frame ids, dir_enc
    (dir_dim, M) direction encoding (a (1, M) zero row without directions),
    all float32; ``tile_flags`` optional int32 (ceil(M / TILE),).
    -> (rgb (3, M), sigma (M,)), raw.

    CPU tensors run :func:`fused_field_reference`. CUDA tensors launch the
    kernel, and any failure to build or launch it raises.
    """
    _check_inputs(field, xyz, ids, dir_enc, tile_flags)
    if xyz.device.type == "cpu":
        return fused_field_reference(field, xyz, ids, dir_enc, tile_flags)
    if xyz.device.type != "cuda":
        raise ValueError(f"fused_field runs on cpu or cuda, not {xyz.device}")
    _check_kernel_support(field)
    from ._build import load_library

    lib = load_library()
    m = xyz.shape[1]
    out = torch.empty((4, m), dtype=torch.float32, device=xyz.device)
    spec = field.spec
    ptr = ctypes.c_void_p
    with torch.cuda.device(xyz.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.stnerf_fused_field(
            ptr(xyz.data_ptr()), ptr(ids.data_ptr()), ptr(dir_enc.data_ptr()),
            ptr(None if tile_flags is None else tile_flags.data_ptr()),
            ptr(field.weights.data_ptr()), ptr(field.biases.data_ptr()),
            field.offsets.ctypes.data_as(ptr), ptr(out.data_ptr()),
            m, dir_enc.shape[0], spec.backbone_dim, spec.head_dim,
            field.motion_width, spec.pos_freqs, int(spec.include_input),
            int(spec.use_time), field.n_rgb, MOTION_MODES[field.motion_mode],
            int(field.compute_dtype == "bfloat16"), ptr(stream))
    if err != 0:
        raise RuntimeError(f"fused_field kernel launch failed: CUDA error {err}")
    fused_field.launches += 1
    return out[:3], out[3]


fused_field.launches = 0
