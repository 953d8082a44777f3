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

The kernels tile layers of :data:`KERNEL_WIDTHS` units. :func:`pack_field`
lays a field of any other trunk, head or motion width out at the next
kernel width (:func:`kernel_width`): the padded units have zero weights and
biases and so do the rows that feed them from the layer below, so each is
ReLU(0) = 0 and feeds nothing. Outputs and the real gradients stay the
model's; :func:`_linear_grads` cuts the padded ones away. Widths above 1024
pack unpadded, and the kernels refuse them.

Every kernel takes every kernel width: each launch picks the largest
sample block whose activations fit a block's shared memory (forward: 64,
32 or 16 samples on the float32 route, 128, 64 or 32 on the tensor cores;
backward: 64, 32 or 16 on both; at widths up to 256 always the first).
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
KERNEL_WIDTHS = (32, 64, 128, 256, 512, 1024)  # layer widths the kernels take

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
# weights fed by an encoding (their rows are not a layer width), and the
# 1- and 3-wide output layers (their columns are not one)
_INPUT_ROWS = ("w1", "s2b", "r1b", "r1c", "m0")
_THIN = ("dw", "db", "m5", "mb5")


def kernel_width(n: int) -> int:
    """The least of :data:`KERNEL_WIDTHS` >= n; n itself above the widest."""
    return next((w for w in KERNEL_WIDTHS if w >= n), n)


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
    """One field's kernel operands in two flat buffers, at the kernel
    widths (``shapes``); ``model_shapes`` and ``spec`` are the model's own."""
    weights: torch.Tensor        # 1-D, compute dtype
    biases: torch.Tensor         # 1-D float32
    offsets: np.ndarray          # int32 [len(W_SLOTS) + len(B_SLOTS)], -1 = absent
    shapes: dict                 # slot -> (in, out) or (out,), as packed
    model_shapes: dict           # slot -> the model's (in, out) or (out,)
    spec: SpaceNetSpec
    motion_mode: str | None
    motion_width: int            # as packed
    compute_dtype: str

    @property
    def width(self) -> int:
        """The trunk's width as packed."""
        return self.shapes["w1"][1]

    @property
    def head(self) -> int:
        """The rgb head's width as packed."""
        return self.shapes["r1a"][1]

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

    def cut(self, slot: str, t: torch.Tensor) -> torch.Tensor:
        """A packed operand of ``slot`` (or its gradient) cut to the model's
        own shape: the padded rows and columns dropped."""
        return t[tuple(slice(0, n) for n in self.model_shapes[slot])]

    @functools.cached_property
    def tc(self) -> tuple:
        """The tensor-core kernels' operands: (fragments, offsets). The
        fragments are the weights gathered into :func:`tc_fragments` order
        (one indexed copy on the weights' device); the offsets are
        ``self.offsets`` followed by the forward and backward fragment
        offsets, in 16-byte units (:func:`_tc_index`), and each weight
        slot's first row in :attr:`tc_norms` (:func:`_norm_jobs`)."""
        shapes = tuple(sorted((s, v) for s, v in self.shapes.items() if s in W_SLOTS))
        idx, f_offs, g_offs = _tc_index(self.weights.device, self.weights.numel(), shapes,
                                        tuple(int(o) for o in self.offsets[:len(W_SLOTS)]))
        src = torch.cat([self.weights, self.weights.new_zeros(1)])
        n_offs = _norm_jobs(self)[0]
        return src[idx], np.concatenate([self.offsets, f_offs, g_offs, n_offs]).astype(np.int32)

    @functools.cached_property
    def tc_norms(self) -> torch.Tensor:
        """The squared L2 norm of each output row of every weight slot that a
        checked tensor-core product takes (float32, the slots in
        :data:`W_SLOTS` order): WideRule's |w_r| of K1's checked forward and
        of K3's forward (``csrc/tc_blocks.cuh``), made once per packed field
        by ``stnerf_tc_row_norms`` on the weights' CUDA device; the bf16
        backward makes the same values once a launch with the same kernel,
        ``row_norms_kernel``."""
        from ._build import load_library

        _, jobs = _norm_jobs(self)
        out = torch.empty(int(jobs[:, 2].sum()), dtype=torch.float32,
                          device=self.weights.device)
        ptr = ctypes.c_void_p
        with torch.cuda.device(out.device):
            err = load_library().stnerf_tc_row_norms(
                ptr(self.weights.data_ptr()), jobs.ctypes.data_as(ptr), len(jobs),
                ptr(out.data_ptr()), ptr(torch.cuda.current_stream().cuda_stream))
        if err != 0:
            raise RuntimeError(f"stnerf_tc_row_norms launch failed: CUDA error {err}")
        return out

    @functools.cached_property
    def dx_frags(self) -> torch.Tensor:
        """The float32 backward kernels' dx operands (``f32_bwd.dx_fragments``),
        made once per packed field on the weights' device."""
        from .f32_bwd import dx_fragments

        return dx_fragments(self)


def pack_field(space_ops: tuple, motion_ops: tuple, spec: SpaceNetSpec,
               motion_mode: str | None = None,
               compute_dtype: str = "bfloat16") -> PackedField:
    """Pack the operand tuples of :func:`prepare_kernel_params_planar` and
    :func:`prepare_motion_params_planar` once per field, every trunk, head
    and motion width at :func:`kernel_width` (zeros in the padded units)."""
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
    thin = (*_THIN, f"rgb{len(rest) // 2}", f"rgbb{len(rest) // 2}")
    model_shapes = {s: tuple(t.shape) if s in W_SLOTS else (t.shape[0],)
                    for s, t in named.items()}
    packed = {}
    for s, (k, *o) in model_shapes.items():
        if s in W_SLOTS:
            packed[s] = (k if s in _INPUT_ROWS else kernel_width(k),
                         o[0] if s in thin else kernel_width(o[0]))
        else:
            packed[s] = (k if s in thin else kernel_width(k),)

    def layout(slots):
        offs, total = [], 0
        for s in slots:
            if s in packed:
                offs.append(total)
                total += -(-int(np.prod(packed[s])) // _ALIGN) * _ALIGN
            else:
                offs.append(-1)
        return offs, total

    w_offs, w_total = layout(W_SLOTS)
    b_offs, b_total = layout(B_SLOTS)
    device = named["w1"].device
    weights = torch.zeros(w_total, dtype=dtype, device=device)
    biases = torch.zeros(b_total, dtype=torch.float32, device=device)
    for slots, offs, buf in ((W_SLOTS, w_offs, weights), (B_SLOTS, b_offs, biases)):
        for s, off in zip(slots, offs):
            if off < 0:
                continue
            t = named[s].reshape(model_shapes[s]).to(buf.dtype)
            if packed[s] != model_shapes[s]:
                t, real = torch.zeros(packed[s], dtype=buf.dtype, device=device), t
                t[tuple(slice(0, n) for n in real.shape)] = real
            buf[off:off + t.numel()] = t.reshape(-1)
    motion_width = packed["m0"][1] if motion_mode else 0
    return PackedField(weights, biases,
                       np.asarray(w_offs + b_offs, np.int32), packed, model_shapes, spec,
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


def _norm_jobs(field: PackedField) -> tuple:
    """The weight slots of the checked products, those with forward
    fragments (every layer of width >= 32; :func:`_tc_index`) -> (each W
    slot's first row in :attr:`PackedField.tc_norms`, -1 for none; an int32
    (slots, 3) array of each such slot's packed offset, inputs and outputs,
    in :data:`W_SLOTS` order)."""
    n_offs, jobs, at = [], [], 0
    for i, slot in enumerate(W_SLOTS):
        if slot not in field.shapes or field.shapes[slot][1] < 32:
            n_offs.append(-1)
            continue
        k_in, k_out = field.shapes[slot]
        n_offs.append(at)
        jobs.append((int(field.offsets[i]), k_in, k_out))
        at += k_out
    return np.asarray(n_offs, np.int32), np.asarray(jobs, np.int32).reshape(-1, 3)


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


def check_forward_widths(widths: list):
    """The kernels, forward (K1, K3, K6) and backward (K2, K3's), take
    layer widths up to 1024, packed at :data:`KERNEL_WIDTHS`: above 256 a
    launch takes a smaller sample block, so that its activations still fit
    a block's 227 KB of shared memory."""
    if any(w not in KERNEL_WIDTHS for w in widths):
        raise ValueError(f"the CUDA kernels take layer widths of at most "
                         f"{KERNEL_WIDTHS[-1]} (packed at {KERNEL_WIDTHS}), got {widths}: the "
                         "activations of a 16-sample block (float32, and bf16 backward) or a "
                         "32-sample block (bf16 forward) must fit a block's 227 KB of shared "
                         "memory")


def field_widths(field: PackedField) -> list:
    """The packed widths a kernel tiles: trunk, head and motion net."""
    return [field.width, field.head] + ([field.motion_width] if field.motion_mode else [])


def _check_time(field: PackedField):
    spec = field.spec
    if spec.use_time and spec.time_freqs != spec.pos_freqs:
        raise ValueError("the kernel encodes time with pos_freqs octaves")


def check_forward_support(field: PackedField):
    """What the forward kernels take of a field: its widths
    (:func:`check_forward_widths`) and its time encoding."""
    check_forward_widths(field_widths(field))
    _check_time(field)


def check_backward_support(field: PackedField):
    """What the backward kernels take of a field: what the forward kernels
    take (:func:`check_forward_support`)."""
    check_forward_support(field)


def kernel_ints(field: PackedField, m: int, dir_rows: int) -> tuple:
    """The ints K1's and K2's entry points take: the sample count, the
    direction rows, the packed widths, then the encoding, the rgb head and
    the motion mode."""
    spec = field.spec
    return (m, dir_rows, field.width, field.head, field.motion_width, spec.pos_freqs,
            int(spec.include_input), int(spec.use_time), field.n_rgb,
            MOTION_MODES[field.motion_mode])


def _check_taps(taps: torch.Tensor | None, tc: bool, dev: torch.device,
               what: str) -> None:
    """``taps`` are read back from a checked tensor-core forward on the card:
    refused for a CPU tensor, the float32 route and the render route."""
    if taps is not None and not (tc and dev.type == "cuda"):
        raise ValueError(f"{what} takes taps on the card's checked bf16 route only")


def _workspace(given: torch.Tensor | None, nbytes: int, dev: torch.device) -> torch.Tensor:
    """A new uint8 device buffer of ``nbytes``, or the caller's (checked)."""
    if given is None:
        return torch.empty(nbytes, dtype=torch.uint8, device=dev)
    if (given.dtype != torch.uint8 or given.device != dev or not given.is_contiguous()
            or given.numel() < nbytes):
        raise ValueError(f"the buffer must be contiguous uint8 of at least {nbytes} "
                         f"bytes on {dev}, got {given.dtype} {given.numel()} on {given.device}")
    return given


def fused_field(field: PackedField, xyz: torch.Tensor, ids: torch.Tensor,
                dir_enc: torch.Tensor, tile_flags: torch.Tensor | None = None,
                checked: bool = False, *, taps: torch.Tensor | None = None):
    """Evaluate one (optionally deformed) radiance field.

    xyz (3, M) canonical positions, ids (1, M) frame ids, dir_enc
    (dir_dim, M) direction encoding (a (1, M) zero row without directions),
    all float32; ``tile_flags`` optional int32 (ceil(M / TILE),).
    -> (rgb (3, M), sigma (M,)), raw.

    CPU tensors run :func:`fused_field_reference`. CUDA tensors launch the
    tensor-core kernel for a bf16 field and the CUDA-core kernel for a
    float32 one, and any failure to build or launch it raises. ``checked``
    (the training forward) has the tensor-core kernel recompute in float32
    the outputs whose sum lies near a bf16 rounding tie or 0, so that they
    round as the plain version rounds them, by the rule of the bf16
    backward's recompute (``csrc/fused_field_tc.cu``). ``taps``: for checks
    only, a caller-made uint8 CUDA tensor of at least :func:`tc_launch`'s
    ``taps_bytes`` into which the checked bf16 route copies each block's
    encodings and bf16 layer outputs, in the bf16 backward's record layout
    at this launch's block (``chip_smoke.fwd_taps``); a CPU tensor, the
    float32 route and the unchecked route refuse them.
    """
    _check_inputs(field, xyz, ids, dir_enc, tile_flags)
    _check_taps(taps, checked and field.compute_dtype == "bfloat16", xyz.device, "fused_field")
    if xyz.device.type == "cpu":
        return fused_field_reference(field, xyz, ids, dir_enc, tile_flags)
    if xyz.device.type != "cuda":
        raise ValueError(f"fused_field runs on cpu or cuda, not {xyz.device}")
    check_forward_support(field)
    from ._build import load_library

    lib = load_library()
    m = xyz.shape[1]
    out = torch.empty((4, m), dtype=torch.float32, device=xyz.device)
    ptr = ctypes.c_void_p
    tc = field.compute_dtype == "bfloat16"
    ints = kernel_ints(field, m, dir_enc.shape[0])
    with torch.cuda.device(xyz.device):
        stream = ptr(torch.cuda.current_stream().cuda_stream)
        inputs = (ptr(xyz.data_ptr()), ptr(ids.data_ptr()), ptr(dir_enc.data_ptr()),
                  ptr(None if tile_flags is None else tile_flags.data_ptr()),
                  ptr(field.weights.data_ptr()))
        if tc:
            frags, offsets = field.tc
            norms = ptr(field.tc_norms.data_ptr() if checked else None)
            if taps is not None:
                taps = _workspace(taps, tc_launch(field, m, dir_enc.shape[0], True)["taps_bytes"],
                                 xyz.device)
            err = lib.stnerf_fused_field_tc(
                *inputs, ptr(frags.data_ptr()), ptr(field.biases.data_ptr()), norms,
                offsets.ctypes.data_as(ptr), ptr(out.data_ptr()), *ints, int(checked),
                ptr(None if taps is None else taps.data_ptr()), stream)
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


def float32_ring(field: PackedField, m: int, dir_rows: int) -> dict:
    """The float32 kernel's launch for this field at ``m`` samples: its
    sample block, the weight ring's stages (``csrc/w_ring.cuh``), a stage's
    bytes and the block's dynamic shared memory. Needs the card."""
    from ._build import load_library

    check_forward_support(field)
    out = np.zeros(4, np.int32)
    err = load_library().stnerf_fused_field_ring(*kernel_ints(field, m, dir_rows),
                                                 out.ctypes.data_as(ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"fused_field ring query failed: CUDA error {err}")
    return {"stages": int(out[0]), "stage_bytes": int(out[1]), "smem_bytes": int(out[2]),
            "block_samples": int(out[3])}


def tc_launch(field: PackedField, m: int, dir_rows: int, checked: bool = False) -> dict:
    """The tensor-core kernel's launch for this bf16 field at ``m`` samples
    (``csrc/fused_field_tc.cu``): its sample block, the block's dynamic
    shared memory, and the taps' rows a block and bytes (the ``taps`` of
    the checked route). Needs the card."""
    from ._build import load_library

    check_forward_support(field)
    out = np.zeros(3, np.int32)
    err = load_library().stnerf_fused_field_tc_block(*kernel_ints(field, m, dir_rows),
                                                     int(checked),
                                                     out.ctypes.data_as(ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"fused_field_tc block query failed: CUDA error {err}")
    bm, rows = int(out[0]), int(out[2])
    return {"block_samples": bm, "smem_bytes": int(out[1]), "tap_rows": rows,
            "taps_bytes": -(-m // bm) * rows * bm * 2}


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
    :func:`_field_linears`, each of the linear's own shape: the padded units'
    rows and columns cut away (:meth:`PackedField.cut`), the split first
    layers of stage 2 and of the rgb head joined again, and the gradients of
    the (1, head) zero dummies that stand in for a missing direction or time
    input dropped."""
    spec = field.spec

    def w(*slots):
        return torch.cat([field.cut(s, field.w(s, gw)) for s in slots], 0).t().contiguous()

    def b(slot):
        return field.cut(slot, field.b(slot, gb)).clone()

    out = [(w(f"w{k}"), b(f"b{k}")) for k in (1, 2, 3, 4)]
    out += [(w("s2a", "s2b"), b("sb1")), (w("s2w2"), b("sb2")),
            (w("s2w3"), b("sb3")), (w("dw"), b("db"))]
    r1 = ["r1a"] + ["r1b"] * bool(spec.dir_dim) + ["r1c"] * bool(spec.time_dim)
    out.append((w(*r1), b("rb1")))
    out += [(w(f"rgb{i}"), b(f"rgbb{i}")) for i in range(1, field.n_rgb)]
    if field.motion_mode:
        out += [(w(f"m{k}"), b(f"mb{k}")) for k in range(6)]
    return out
