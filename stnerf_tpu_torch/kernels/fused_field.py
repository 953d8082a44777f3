"""Fused field evaluation: MotionNet displacement, positional encodings and
the SpaceNet MLP in one kernel — the port of
``stnerf_tpu/kernels/fused_field.py::fused_field``.

Three pieces, as for every kernel of the port:

* :func:`fused_field` — the wrapper. On a CUDA tensor it launches a
  hand-written kernel (built at first use by ``_build.py``) or raises: a
  bf16 field goes to the tensor-core kernel ``csrc/fused_field_tc.cu``, a
  float32 one to the CUDA-core kernel ``csrc/fused_field.cu``. On a CPU
  tensor it runs the plain version.
* :func:`fused_field_reference` — the plain PyTorch version: the same math
  on the same packed operands, with the kernel's double-angle encoding and
  its per-layer rounding to the compute dtype.
* ``fused_field.launches`` — how many times the wrapper launched a kernel,
  and ``fused_field.launches_tc`` how many of those went to the tensor-core
  kernel.

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
import functools
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

    @functools.cached_property
    def tc(self) -> tuple:
        """The tensor-core kernels' operands: (fragments, offsets). The
        fragments are the weights gathered into :func:`tc_fragments` order
        (one indexed copy on the weights' device); the offsets are
        ``self.offsets`` followed by the forward and backward fragment
        offsets, in 16-byte units (:func:`_tc_index`)."""
        shapes = tuple(sorted((s, v) for s, v in self.shapes.items() if s in W_SLOTS))
        idx, f_offs, g_offs = _tc_index(self.weights.device, self.weights.numel(), shapes,
                                        tuple(int(o) for o in self.offsets[:len(W_SLOTS)]))
        src = torch.cat([self.weights, self.weights.new_zeros(1)])
        return src[idx], np.concatenate([self.offsets, f_offs, g_offs]).astype(np.int32)


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


def tc_fragments(a: np.ndarray) -> np.ndarray:
    """A (M, K) matrix -> the flat A-operand fragments of wgmma m64k16 for
    ``csrc/tc_blocks.cuh``. M is padded to a multiple of 64 and K to one of
    16 with -1 (a zero weight). Order: m-tile, k-step, then the 128 threads
    of a warpgroup (warp w, lane l), then each thread's 8 values: its four
    registers hold (row, col), (row, col + 1) with row = 16 w + l // 4 (+ 8
    in registers 1 and 3) and col = 2 (l % 4) (+ 8 in registers 2 and 3)."""
    m, k = a.shape
    mp, kp = -(-m // 64) * 64, -(-k // 16) * 16
    p = np.full((mp, kp), -1, np.int64)
    p[:m, :k] = a
    # (m-tile, warp, row half, lane // 4, k-step, col half, lane % 4, pair)
    p = p.reshape(mp // 64, 4, 2, 8, kp // 16, 2, 4, 2)
    return p.transpose(0, 4, 1, 3, 6, 5, 2, 7).reshape(-1)


@functools.lru_cache(maxsize=64)
def _tc_index(device: torch.device, n_weights: int, shapes: tuple, offsets: tuple) -> tuple:
    """The gather that lays a packed field's weights out for the tensor-core
    kernels, built once per layout and device: -> (index into the weights,
    ``n_weights`` for a zero; forward fragment offsets; backward fragment
    offsets), the offsets per weight slot in 16-byte units (-1 for an absent
    or a 1- or 3-wide layer). The forward (y = W^T x) reads A = W^T, the
    backward's dx = W dy reads A = W, each through :func:`tc_fragments`.
    ``shapes`` are the weight slots' (slot, (in, out)) pairs, ``offsets``
    their packed offsets in W_SLOTS order."""
    w_offs, shapes = dict(zip(W_SLOTS, offsets)), dict(shapes)
    parts, f_offs, g_offs, total = [], [], [], 0
    for dest, transpose in ((f_offs, True), (g_offs, False)):
        for slot in W_SLOTS:
            if slot not in shapes or shapes[slot][1] < 32:  # thin layers stay on CUDA cores
                dest.append(-1)
                continue
            k_in, k_out = shapes[slot]
            idx = w_offs[slot] + np.arange(k_in * k_out).reshape(k_in, k_out)
            frag = tc_fragments(idx.T if transpose else idx)
            dest.append(total // 8)
            parts.append(frag)
            total += frag.size
    index = np.concatenate(parts)
    index[index < 0] = n_weights
    return (torch.as_tensor(index, device=device), np.asarray(f_offs, np.int32),
            np.asarray(g_offs, np.int32))


def _encode(v: torch.Tensor, spec: SpaceNetSpec) -> torch.Tensor:
    """The kernel's encoding: double-angle recursion, pos_freqs octaves for
    every input (``fused_field.py:43-56``)."""
    return positional_encoding_planar(v, spec.pos_freqs, spec.include_input,
                                      recursive=True)


def spacenet_chain(field: PackedField, p: torch.Tensor, d_in: torch.Tensor,
                   t_enc: torch.Tensor | None):
    """The SpaceNet part of the kernels on encodings already rounded to the
    compute dtype (``spacenet_vjp._fwd_chain``): p (pos_dim, M), d_in
    (dir_rows, M), t_enc (time_dim, M) or None. -> (a, sigma (1, M), hs):
    the seven trunk activations, and the rgb head's activations with the
    raw rgb (3, M) last."""
    dt = field.dtype

    def r(x):
        return round_to(x, dt)

    def mm(slot, x):
        return field.w(slot).float().t() @ x

    def b(slot):
        return field.b(slot)[:, None]

    relu = torch.relu
    a = [r(relu(mm("w1", p) + b("b1")))]
    for k in (2, 3, 4):
        a.append(r(relu(mm(f"w{k}", a[-1]) + b(f"b{k}"))))
    a.append(r(relu(mm("s2a", a[3]) + mm("s2b", p) + b("sb1"))))
    a.append(r(relu(mm("s2w2", a[4]) + b("sb2"))))
    a.append(r(relu(mm("s2w3", a[5]) + b("sb3"))))
    sigma = mm("dw", a[6]) + b("db")
    h = mm("r1a", relu(a[6])) + mm("r1b", relu(d_in))
    if t_enc is not None:
        h = h + mm("r1c", relu(t_enc))
    hs = [r(relu(h + b("rb1")))]
    for i in range(field.n_rgb - 1):
        y = mm(f"rgb{i + 1}", hs[-1]) + b(f"rgbb{i + 1}")
        hs.append(r(relu(y)) if i < field.n_rgb - 2 else y)
    return a, sigma, hs


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
                h = r(torch.relu(h))
        xyz = xyz + h

    t_enc = r(_encode(ids, spec)) if spec.use_time else None
    _, sigma, hs = spacenet_chain(field, r(_encode(xyz, spec)), r(dir_enc), t_enc)
    rgb, sigma = hs[-1], sigma[0]
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
    tensor-core kernel for a bf16 field and the CUDA-core kernel for a
    float32 one, and any failure to build or launch it raises.
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
    tc = field.compute_dtype == "bfloat16"
    ints = (m, dir_enc.shape[0], spec.backbone_dim, spec.head_dim, field.motion_width,
            spec.pos_freqs, int(spec.include_input), int(spec.use_time), field.n_rgb,
            MOTION_MODES[field.motion_mode])
    with torch.cuda.device(xyz.device):
        stream = ptr(torch.cuda.current_stream().cuda_stream)
        inputs = (ptr(xyz.data_ptr()), ptr(ids.data_ptr()), ptr(dir_enc.data_ptr()),
                  ptr(None if tile_flags is None else tile_flags.data_ptr()),
                  ptr(field.weights.data_ptr()))
        if tc:
            frags, offsets = field.tc
            err = lib.stnerf_fused_field_tc(
                *inputs, ptr(frags.data_ptr()), ptr(field.biases.data_ptr()),
                offsets.ctypes.data_as(ptr), ptr(out.data_ptr()), *ints, stream)
        else:
            err = lib.stnerf_fused_field(
                *inputs, ptr(field.biases.data_ptr()), field.offsets.ctypes.data_as(ptr),
                ptr(out.data_ptr()), *ints, stream)
    if err != 0:
        raise RuntimeError(f"fused_field kernel launch failed: CUDA error {err}")
    fused_field.launches += 1
    fused_field.launches_tc += int(tc)
    return out[:3], out[3]


fused_field.launches = 0
fused_field.launches_tc = 0


# ---------------------------------------------------------------------------
# packed gradients <-> the nn.Linear parameters
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
