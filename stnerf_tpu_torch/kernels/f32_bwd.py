"""The plan of the float32 backward kernels of K2 and K3
(``csrc/f32_bwd.cuh``): what pass 1 writes where, and how passes 2 and 3
sum it.

Pass 1 runs a block per record of ``block`` samples and copies every
layer's float32 input x and output cotangent dy into it. The block is the
largest of 64, 32 and 16 samples whose pass-1 shared memory
(:func:`pass1_smem_bytes`) fits the card's: 64 at every width up to 256,
one skip-flag tile (``fused_field.TILE``); 32 at 512 and 16 at 1024, part
of a tile, whose flag block b reads at ``b // (TILE // block)``. A record
is a run of tiles in :data:`REC_TILES` order; a tile is its rows of
``block`` floats, one a sample (the cotangents that pass 1 makes on the
tensor cores with the samples of row o swizzled, ``csrc/f32_bwd.cuh``
swz). Pass 2 sums dW = x dy^T
and db = sum dy over the records, one job per layer: a block takes one tile
of a job's dW (128 x 128, or 256 x 4 for the 1- and 3-wide layers) over one
range of records and writes that range's float32 partials. Passes 1 and 2
run over slices of at most ``slice_blocks`` records, in order, so that the
records of one slice are held at a time. Pass 3 sums each entry's partials
in (slice, range) order: the gradients are the same on every run.

Every dx = W dy of pass 1 whose layer has a multiple of 8 outputs runs on
the tensor cores, from W in mma A-fragment order (:func:`dx_fragments`,
float32; the kernel splits it into TF32 high and low parts): for each
16-row tile of W (rows padded with zeros to a kernel width) and each step
of 8 outputs, a float4 for each of the 32 lanes of a warp.

:func:`make_plan` computes all of it from a packed field's shapes and the
sample count; :meth:`Plan.array` is what the C entry points read, and
:meth:`Plan.workspace_bytes` what the wrapper allocates for them. It needs
no device, so the tests check the layout on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .fused_field import (B_SLOTS, KERNEL_WIDTHS, W_SLOTS, PackedField,
                          check_forward_widths, field_widths)

# the record's tiles, in csrc/f32_bwd.cuh's enum Tile order
REC_TILES = ("hs0", "hs1", "hs2", "dhs0", "dhs1", "dhs2", "g3rgb",
             *(f"a{k}" for k in range(7)), *(f"d{k}" for k in range(7)),
             "pos", "dir", "time", "sig",
             *(f"u{k}" for k in range(6)), *(f"du{k}" for k in range(1, 6)), "g3m")
JOB_INTS = 8     # x, k_in, y, o, w_off, b_off, mt, nt
PLAN_HEAD = 5    # rec_floats, slice_blocks, ranges, n_jobs, block
MAX_JOBS = 24
WIDE = 128       # a wide tile of dW: WIDE x WIDE
NARROW_K, NARROW_O = 256, 4  # a narrow tile, for layers of <= 4 outputs
SLICE_BYTES = 4 << 30        # records held at a time, at most
RANGES_PER_SM = 6            # pass 2: at most six wide tiles per SM in each slice
BLOCKS = (64, 32, 16)        # pass 1's sample blocks, the largest that fits first
SMEM_OPTIN = 232_448         # a block's shared memory on an H100 (227 KB)


@dataclasses.dataclass(frozen=True)
class Plan:
    """One call's plan. ``tile``: per :data:`REC_TILES` entry, its offset
    in floats within a record (-1 absent); ``frag``: per weight slot, the
    offset of its dx fragments in floats (-1: dx on CUDA cores); ``jobs``:
    (n_jobs, JOB_INTS) int32, in pass 2's order; ``block``: a record's
    samples."""
    tile: np.ndarray
    frag: np.ndarray
    rec_floats: int
    jobs: np.ndarray
    n_blocks: int
    slice_blocks: int
    ranges: int
    n_params: int
    block: int

    @property
    def n_slices(self) -> int:
        return -(-self.n_blocks // self.slice_blocks)

    @property
    def workspace_bytes(self) -> int:
        """One slice's records, then every (slice, range)'s partials."""
        return 4 * (self.slice_blocks * self.rec_floats
                    + self.n_slices * self.ranges * self.n_params)

    def array(self) -> np.ndarray:
        """The int32 array the C entry points read (f32_bwd.cuh
        ``read_plan``): rec_floats, slice_blocks, ranges, n_jobs, the block,
        the tile offsets, the fragment offsets, the jobs."""
        head = [self.rec_floats, self.slice_blocks, self.ranges, len(self.jobs), self.block]
        return np.concatenate([np.asarray(head, np.int32), self.tile, self.frag,
                               self.jobs.reshape(-1)]).astype(np.int32)

    def record_ranges(self) -> list:
        """Pass 2's ranges in pass 3's order: (slice, range, first block,
        end block), blocks counted from sample 0 (the kernel's split)."""
        out = []
        for s in range(self.n_slices):
            b0 = s * self.slice_blocks
            nb = min(self.slice_blocks, self.n_blocks - b0)
            out += [(s, r, b0 + r * nb // self.ranges, b0 + (r + 1) * nb // self.ranges)
                    for r in range(self.ranges)]
        return out


def record_rows(field: PackedField) -> dict:
    """{tile: rows} of the tiles a record holds for this field."""
    s = field.shapes
    W, H = s["w1"][1], s["r1a"][1]
    rows = {f"a{k}": W for k in range(7)} | {f"d{k}": W for k in range(7)}
    for i in range(field.n_rgb - 1):
        rows[f"hs{i}"] = rows[f"dhs{i}"] = H
    rows.update(g3rgb=3, sig=1, pos=s["w1"][0], dir=s["r1b"][0])
    if field.spec.use_time:
        rows["time"] = s["r1c"][0]
    if field.motion_mode:
        rows["u0"] = s["m0"][0]
        for k in range(1, 6):
            rows[f"u{k}"] = rows[f"du{k}"] = field.motion_width
        rows["g3m"] = 3
    return rows


def job_list(field: PackedField) -> list:
    """Pass 2's jobs in order: (weight slot, bias slot or None, x tile, dy
    tile). The time input's weights only with a time input; the motion
    net's with one."""
    last = field.n_rgb - 2
    jobs = [(f"rgb{last + 1}", f"rgbb{last + 1}", f"hs{last}", "g3rgb")]
    jobs += [(f"rgb{i + 1}", f"rgbb{i + 1}", f"hs{i}", f"dhs{i + 1}")
             for i in reversed(range(last))]
    jobs += [("r1a", "rb1", "a6", "dhs0"), ("r1b", None, "dir", "dhs0")]
    if field.spec.use_time:
        jobs.append(("r1c", None, "time", "dhs0"))
    jobs += [("dw", "db", "a6", "sig"), ("s2w3", "sb3", "a5", "d6"),
             ("s2w2", "sb2", "a4", "d5"), ("s2a", "sb1", "a3", "d4"),
             ("s2b", None, "pos", "d4"), ("w4", "b4", "a2", "d3"),
             ("w3", "b3", "a1", "d2"), ("w2", "b2", "a0", "d1"), ("w1", "b1", "pos", "d0")]
    if field.motion_mode:
        jobs.append(("m5", "mb5", "u5", "g3m"))
        jobs += [(f"m{k}", f"mb{k}", f"u{k}", f"du{k + 1}") for k in (4, 3, 2, 1)]
        jobs.append(("m0", "mb0", "u0", "du1"))
    return jobs


def padded_rows(k: int) -> int:
    """The rows of a dx operand's fragments: the least kernel width >= k."""
    return next(w for w in KERNEL_WIDTHS if w >= k)


def max_width(block: int) -> int:
    """The widest layer a pass-1 block of ``block`` samples takes: a thread
    keeps at most 64 of its outputs (``csrc/f32_bwd.cuh`` max_width)."""
    return 16384 // block


def pass1_smem_bytes(field: PackedField, block: int) -> int:
    """Pass 1's dynamic shared memory for a block of ``block`` samples
    (``csrc/f32_bwd.cuh`` smem_bytes): 14 per-sample rows, the encodings
    and d(pos enc), two ping-pong tiles as wide as the widest layer (the
    motion net's encoding too), as float32 rows of the block, then the
    ReLU masks, a bit a sample."""
    s = field.shapes
    width, head = s["w1"][1], s["r1a"][1]
    pos_rows, dir_rows = s["w1"][0], s["r1b"][0]
    time_rows = s["r1c"][0] if field.spec.use_time else 0
    motion = field.motion_width if field.motion_mode else 0
    rows_a = max(width, head, motion, s["m0"][0] if field.motion_mode else 0)
    rows = 14 + 2 * pos_rows + dir_rows + time_rows + 2 * rows_a
    return 4 * rows * block + (7 * width + 3 * head + 5 * motion) * block // 8


def choose_block(field: PackedField, smem_limit: int = SMEM_OPTIN) -> int:
    """Pass 1's block: the largest of :data:`BLOCKS` whose shared memory
    fits ``smem_limit`` bytes and whose threads take the field's widest
    layer."""
    for block in BLOCKS:
        if (pass1_smem_bytes(field, block) <= smem_limit
                and max(field_widths(field)) <= max_width(block)):
            return block
    raise ValueError(f"no pass-1 block of {BLOCKS} samples fits {smem_limit} bytes of "
                     f"shared memory at widths {field_widths(field)}")


def frag_offsets(field: PackedField) -> np.ndarray:
    """Per weight slot, the offset in floats of its dx fragments (-1:
    none): every layer whose input gets a cotangent and that has a multiple
    of 8 outputs, in W_SLOTS order."""
    out, total = np.full(len(W_SLOTS), -1, np.int32), 0
    for i, slot in enumerate(W_SLOTS):
        shape = field.shapes.get(slot)
        if shape is None or slot == "r1c" or shape[1] % 8:
            continue
        out[i] = total
        total += padded_rows(shape[0]) * shape[1]
    return out


@functools.lru_cache(maxsize=None)
def _frag_index(slots: tuple, n_w: int, device: torch.device) -> torch.Tensor:
    """For each float of the dx fragments, its index in the packed weights
    (``n_w``: a zero); ``slots`` is ((k, o, weight offset), ...) in
    fragment order."""
    parts = []
    for k, o, w_off in slots:
        idx = np.full((padded_rows(k), o), n_w, np.int64)
        idx[:k] = w_off + np.arange(k * o).reshape(k, o)
        # (tile, h, g, step, c, q) -> (tile, step, g, q, c, h): a = 2 c + h
        parts.append(idx.reshape(-1, 2, 8, o // 8, 2, 4).transpose(0, 3, 2, 5, 4, 1).reshape(-1))
    return torch.as_tensor(np.concatenate(parts), device=device)


def dx_fragments(field: PackedField) -> torch.Tensor:
    """The dx operands of :func:`frag_offsets`, float32, on the weights'
    device: W (K, O) with its rows padded to :func:`padded_rows`, in mma
    m16n8k8 A-fragment order, gathered in one indexed copy. For row tile t,
    output step s and lane l = 4 g + q: W[16 t + g, 8 s + q],
    W[16 t + g + 8, 8 s + q], W[16 t + g, 8 s + q + 4], W[16 t + g + 8,
    8 s + q + 4]."""
    slots = tuple((*field.shapes[slot], int(field.offsets[i]))
                  for i, (slot, off) in enumerate(zip(W_SLOTS, frag_offsets(field))) if off >= 0)
    idx = _frag_index(slots, field.weights.numel(), field.weights.device)
    return torch.cat([field.weights.float(), field.weights.new_zeros(1, dtype=torch.float32)])[idx]


def make_plan(field: PackedField, m: int, sms: int, smem_limit: int = SMEM_OPTIN) -> Plan:
    """The plan for ``m`` samples of ``field`` on a card with ``sms``
    multiprocessors and ``smem_limit`` bytes of shared memory a block."""
    if m <= 0 or sms <= 0:
        raise ValueError(f"make_plan needs m > 0 and sms > 0, got {m}, {sms}")
    check_forward_widths(field_widths(field))
    block = choose_block(field, smem_limit)
    rows = record_rows(field)
    tile = np.full(len(REC_TILES), -1, np.int32)
    rec_floats = 0
    for i, name in enumerate(REC_TILES):
        if name in rows:
            tile[i] = rec_floats
            rec_floats += rows[name] * block
    n_w = field.weights.numel()
    jobs = []
    for w, b, x, y in job_list(field):
        k_in, o = field.shapes[w]
        assert (k_in, o) == (rows[x], rows[y])
        narrow = o <= NARROW_O
        jobs.append((tile[REC_TILES.index(x)], k_in, tile[REC_TILES.index(y)], o,
                     field.offsets[W_SLOTS.index(w)],
                     -1 if b is None else n_w + field.offsets[len(W_SLOTS) + B_SLOTS.index(b)],
                     -(-k_in // (NARROW_K if narrow else WIDE)),
                     1 if narrow else -(-o // WIDE)))
    jobs = np.asarray(jobs, np.int32)
    assert len(jobs) <= MAX_JOBS
    n_blocks = -(-m // block)
    per_slice = max(1, SLICE_BYTES // (4 * rec_floats) // sms) * sms
    slice_blocks = min(per_slice, n_blocks)
    # the wide tiles cost the same (the narrow ones little): whole waves of them
    wide = int((jobs[:, 6] * jobs[:, 7])[jobs[:, 3] > NARROW_O].sum())
    ranges = max(1, min(slice_blocks, RANGES_PER_SM * sms // wide))
    return Plan(tile, frag_offsets(field), rec_floats, jobs, n_blocks, slice_blocks, ranges,
                n_w + field.biases.numel(), block)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Multiprocessors of the card that holds ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def smem_optin(device: torch.device) -> int:
    """A block's shared memory on the card that holds ``device`` (an H100's
    where the properties do not say)."""
    props = torch.cuda.get_device_properties(device)
    return getattr(props, "shared_memory_per_block_optin", SMEM_OPTIN)
