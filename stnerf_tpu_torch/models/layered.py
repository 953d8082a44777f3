"""The layered spatio-temporal radiance field and its exact render core.

Counterpart of ``stnerf_tpu/models/layered.py`` (ref:
modeling/layered_rfrender.py:19-735) on its exact inference path: a
background field plus L performer fields, each a SpaceNet with a per-layer
MotionNet; BBOX or NEAR_FAR coarse sampling, ``sample_pdf`` fine
resampling over the union of coarse and new samples, and the depth-sorted
merge of every layer's samples. Edits (hide/show, shift, scale, alpha,
near clip, density thresholds) are data in :class:`EditState`.

Without view deformation every field evaluation goes through
``kernels.fused_field``: the hand-written CUDA kernel on the card, its
plain PyTorch version on the CPU (or anywhere with ``plain=True``). Per-ray
bbox hits become the kernel's per-tile skip flags; a performer that is
hidden, or that no ray of the batch hits, gets all-zero flags, so every
block of its launch exits at once without a host round trip. For training
(``render_rays(..., trainable=True)``) each field goes through
``kernels.field_vjp.field_planar_trainable`` instead: the same forward
kernel, and the backward kernel ``field_bwd``.

With view deformation (USE_DEFORM_VIEW) both stages take the staged path,
as the JAX package's trainable-kernel path does: the view, time and
background flows move the samples under autograd (:func:`_deform`), the
encodings are computed outside the kernel, and the SpaceNet MLP runs
through ``kernels.spacenet_vjp.spacenet_planar_trainable`` (forward kernel,
and the backward kernel in training). That kernel has no per-tile skip
flags; a performer that is hidden, or that no ray of the batch hits, is
skipped whole by one device-side flag (JAX's chunk-level ``lax.cond``), and
otherwise runs every sample. Pose refinement (POSE_REFINEMENT) moves the rays
by a learned per-camera rotation and translation (``models/camera.py``)
before sampling the fields, on either path.

With ``nosort_composite`` both merges composite through
``ops.volume.composite_merged_nosort`` (the JAX package's sort-free
training compositor) instead of the sorted merge; with
``compositor_kernel`` too its cross-stream terms come from the kernels K4
and K5 (``kernels.cross_trans``) on the card.

The inference approximations of the JAX package render as its do: the
early-exit coarse march (EARLY_EXIT_SEGMENTS > 1,
:func:`_coarse_march_segmented`), the fast fine stage (FAST_FINE: the fine
nets evaluate only the new importance samples, a performer with ~no coarse
opacity on a ray skips them there), and occupancy sub-box slices
(``SceneBoxes.boxes`` of shape (F, L, K, 2, 3), ``render/occupancy.py``)
with the gap skip (OCC_GAP_SKIP, ``ops.sampling.stratified_union``). Skips
become K1's per-tile flags. The trainer and validation strip the first two,
as JAX's do. Not ported yet: the fast fine stage in training
(FAST_FINE_TRAIN), which ``LayeredSpec`` refuses, and so the fast fine
stage with the sort-free compositor, which ``render_rays`` refuses.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import NamedTuple

import torch
from torch import nn

from ..device import resolve_device
from ..kernels.field_vjp import field_planar_trainable
from ..kernels.fused_field import (TILE, PackedField, fused_field,
                                   fused_field_reference, pack_field,
                                   prepare_kernel_params_planar,
                                   prepare_motion_params_planar)
from ..kernels.spacenet_vjp import spacenet_planar_trainable
from ..ops.encoding import positional_encoding_planar
from ..ops.rounding import round_to
from ..ops.sampling import (MISS_T, ray_aabb_intersect, sample_pdf,
                            stratified_between, stratified_near_far,
                            stratified_union)
from ..ops.volume import (composite_merged_nosort, merge_layers_planar,
                          sort_merge_t, sort_samples_planar,
                          volume_render_planar)
from .camera import CameraTransform, apply_camera_transform
from .motionnet import MotionNet, MotionNetSpec
from .spacenet import SpaceNet, SpaceNetSpec


@dataclasses.dataclass(frozen=True)
class LayeredSpec:
    """Static configuration of the layered model."""

    layer_num: int = 2                 # performer layers; fields = L+1
    coarse_samples: int = 90
    fine_samples: int = 30
    sample_method: str = "BBOX"        # "BBOX" | "NEAR_FAR"
    boarder_weight: float = 1e10
    same_spacenet: bool = False
    include_input: bool = True
    use_dir: bool = True
    use_space_time: bool = False
    bkgd_use_space_time: bool = False
    use_deform_time: bool = False
    bkgd_use_deform_time: bool = False
    use_deform_view: bool = False      # view-deform net over every layer
    pose_refinement: bool = False      # learned per-camera pose correction
    deep_rgb: bool = False
    backbone_dim: int = 256
    head_dim: int = 128
    motion_dim: int = 128
    camera_num: int = 0                # cameras of the pose refinement
    compute_dtype: str = "float32"     # "bfloat16" | "float32"
    nosort_composite: bool = False     # sort-free merged compositor
    compositor_kernel: bool = False    # its cross-stream terms by K4/K5
    # inference approximations (the trainer and validation strip the first
    # two): the fast fine stage skips a performer's fine samples on a ray
    # whose coarse opacity is <= fine_skip_eps; the coarse march runs in
    # coarse_exit_segments dispatches and skips a layer's rays whose own
    # transmittance fell below coarse_exit_eps; 0/1 segments = one dispatch
    fast_fine: bool = False
    fine_skip_eps: float = 1e-3
    coarse_exit_segments: int = 0
    coarse_exit_eps: float = 1e-3
    # with occupancy sub-box slices: stratify each performer's coarse
    # samples over the union of its hit slices (inert without slices)
    occ_gap_skip: bool = False
    # the fast fine stage in training: not ported yet, refused
    fast_fine_train: bool = False

    def __post_init__(self):
        if self.fast_fine_train:
            raise NotImplementedError(
                "not ported to stnerf_tpu_torch yet: FAST_FINE_TRAIN")
        if self.sample_method not in ("BBOX", "NEAR_FAR"):
            raise ValueError(f"unknown SAMPLE_METHOD {self.sample_method!r}")
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"unknown COMPUTE_DTYPE {self.compute_dtype!r}")

    @classmethod
    def from_cfg(cls, cfg, camera_num: int = 0) -> "LayeredSpec":
        """``camera_num``: the training cameras the pose refinement learns a
        correction for (the dataset's camera count)."""
        m = cfg.MODEL
        return cls(
            layer_num=cfg.DATASETS.LAYER_NUM,
            coarse_samples=m.COARSE_RAY_SAMPLING,
            fine_samples=m.FINE_RAY_SAMPLING,
            sample_method=m.SAMPLE_METHOD,
            boarder_weight=float(m.BOARDER_WEIGHT),
            same_spacenet=m.SAME_SPACENET,
            include_input=m.TKERNEL_INC_RAW,
            use_dir=m.USE_DIR,
            use_space_time=m.USE_SPACE_TIME,
            bkgd_use_space_time=m.BKGD_USE_SPACE_TIME,
            use_deform_time=m.USE_DEFORM_TIME,
            bkgd_use_deform_time=m.BKGD_USE_DEFORM_TIME,
            use_deform_view=m.USE_DEFORM_VIEW,
            pose_refinement=m.POSE_REFINEMENT,
            # matches ref: modeling/layered_rfrender.py:35
            deep_rgb=(m.DEEP_RGB and m.USE_SPACE_TIME),
            backbone_dim=m.BACKBONE_DIM,
            head_dim=m.HEAD_DIM,
            motion_dim=m.MOTION_DIM,
            camera_num=camera_num,
            compute_dtype=cfg.TPU.COMPUTE_DTYPE,
            compositor_kernel=cfg.TPU.COMPOSITOR_KERNEL,
            fast_fine=cfg.TPU.FAST_FINE,
            fine_skip_eps=float(cfg.TPU.FAST_FINE_EPS),
            fast_fine_train=cfg.TPU.FAST_FINE_TRAIN,
            coarse_exit_segments=int(cfg.TPU.EARLY_EXIT_SEGMENTS),
            coarse_exit_eps=float(cfg.TPU.EARLY_EXIT_EPS),
            occ_gap_skip=cfg.TPU.OCC_GAP_SKIP,
        )

    def spacenet_spec(self, bkgd: bool) -> SpaceNetSpec:
        return SpaceNetSpec(
            use_dir=self.use_dir,
            use_time=self.bkgd_use_space_time if bkgd else self.use_space_time,
            deep_rgb=self.deep_rgb,
            include_input=self.include_input,
            backbone_dim=self.backbone_dim,
            head_dim=self.head_dim,
        )

    def motion_spec(self, input_time: bool) -> MotionNetSpec:
        return MotionNetSpec(c_input=4, include_input=self.include_input,
                             width=self.motion_dim, input_time=input_time)

    @property
    def dtype(self):
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


class RayInputs(NamedTuple):
    rays_o: torch.Tensor     # (N, 3)
    rays_d: torch.Tensor     # (N, 3)
    frame_ids: torch.Tensor  # (N, L+1) 1-based frame id per layer
    cam_ids: torch.Tensor    # (N,)
    near_far: torch.Tensor   # (N, 2) per-ray near/far (NEAR_FAR)


class SceneBoxes(NamedTuple):
    bkgd_box: torch.Tensor       # (2, 3) min/max
    boxes: torch.Tensor          # (F, L, 2, 3) per-frame performer boxes, or
    # (F, L, K, 2, 3) occupancy sub-box slices (render/occupancy.py)
    bkgd_near_far: torch.Tensor  # (2,) background near/far (NEAR_FAR)


class EditState(NamedTuple):
    """Render-time edits as data (ref: layered_rfrender.py:39-42, 104-127)."""
    visible: torch.Tensor   # (L+1,) 1 shown / 0 hidden
    shift: torch.Tensor     # (L+1, 3)
    scale: torch.Tensor     # (L+1,)
    alpha: torch.Tensor     # (L+1,) density fade (fine stage)
    near: torch.Tensor      # () near clip
    density_threshold: torch.Tensor       # () performer sigma cutoff
    bkgd_density_threshold: torch.Tensor  # () background sigma cutoff
    scale_pivot: torch.Tensor             # (3,) pivot of the scale edit

    @classmethod
    def identity(cls, layer_num: int, scale_pivot=None,
                 device=None) -> "EditState":
        lp1 = layer_num + 1

        def f(shape, v):
            return torch.full(shape, v, dtype=torch.float32, device=device)

        pivot = (f((3,), 0.0) if scale_pivot is None else
                 torch.as_tensor(scale_pivot, dtype=torch.float32, device=device))
        return cls(f((lp1,), 1.0), f((lp1, 3), 0.0), f((lp1,), 1.0),
                   f((lp1,), 1.0), f((), 0.0), f((), 0.0), f((), 0.0), pivot)


class LayerOutputs(NamedTuple):
    color: torch.Tensor  # (..., N, 3)
    depth: torch.Tensor  # (..., N, 1)
    acc: torch.Tensor    # (..., N, 1)


class RenderOutputs(NamedTuple):
    fine: LayerOutputs          # merged fine composite
    coarse: LayerOutputs        # merged coarse composite
    fine_layers: LayerOutputs   # per layer, leading dim L+1
    coarse_layers: LayerOutputs
    hit: torch.Tensor           # (L+1, N) bool bbox hits


def compute_scale_pivot(bkgd_box: torch.Tensor,
                        boxes_frame0: torch.Tensor) -> torch.Tensor:
    """Pivot of the scale edit (ref: layered_rfrender.py:216-232): the mean
    of performers 1 and 2's frame-0 box centres, z taken from the box
    minimum; a single performer uses its own centre."""
    centers = 0.5 * (boxes_frame0[:, 0] + boxes_frame0[:, 1])
    centers = torch.cat([centers[:, :2], boxes_frame0[:, 0, 2:3]], -1)
    if boxes_frame0.shape[0] >= 2:
        return 0.5 * (centers[0] + centers[1])
    return centers[0]


class LayeredModel(nn.Module):
    """Background + performer fields, coarse and fine, with motion nets.

    Init mirrors ``init_layered_params`` (ref:
    modeling/layered_rfrender.py:59-93): every performer starts as a copy
    of performer 0's net, and the fine nets as copies of the coarse ones
    (shared when SAME_SPACENET). Draws come from ``generator`` (a CPU
    generator) in the order background, performer 0, motion net, background
    motion net, view-deform net. The pose refinement starts at the identity
    for ``max(camera_num, 1)`` cameras. The model lands on ``device``: the
    CUDA card unless the caller names another (``device="cpu"``).
    """

    def __init__(self, spec: LayeredSpec,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.spec = spec
        L = spec.layer_num
        bkgd = SpaceNet(spec.spacenet_spec(bkgd=True), generator)
        layer0 = SpaceNet(spec.spacenet_spec(bkgd=False), generator)
        self.bkgd_coarse = bkgd
        self.bkgd_fine = copy.deepcopy(bkgd)
        self.layers_coarse = nn.ModuleList(copy.deepcopy(layer0) for _ in range(L))
        self.layers_fine = (None if spec.same_spacenet else
                            nn.ModuleList(copy.deepcopy(layer0) for _ in range(L)))
        self.motion = None
        if spec.use_deform_time and L:
            m0 = MotionNet(spec.motion_spec(input_time=True), generator)
            self.motion = nn.ModuleList(copy.deepcopy(m0) for _ in range(L))
        self.bkgd_motion = (MotionNet(spec.motion_spec(input_time=False), generator)
                            if spec.bkgd_use_deform_time else None)
        self.view_deform = (MotionNet(spec.motion_spec(input_time=False), generator)
                            if spec.use_deform_view else None)
        self.cam_pose = (CameraTransform(max(spec.camera_num, 1))
                         if spec.pose_refinement else None)
        self._packed = {}
        self.to(device)

    def stage_fields(self, fine: bool) -> list:
        """(SpaceNet, MotionNet or None, motion mode) per field at one
        stage: the background deforms with "direct" motion
        (BKGD_USE_DEFORM_TIME), performers with "lerp"."""
        layers = (self.layers_fine if fine and self.layers_fine is not None
                  else self.layers_coarse)
        fields = [(self.bkgd_fine if fine else self.bkgd_coarse, self.bkgd_motion,
                   None if self.bkgd_motion is None else "direct")]
        return fields + [(net, None if self.motion is None else self.motion[i],
                          None if self.motion is None else "lerp")
                         for i, net in enumerate(layers)]

    @torch.no_grad()
    def kernel_fields(self, fine: bool) -> list[PackedField]:
        """The packed kernel operands of :meth:`stage_fields`, packed once
        and reused until a parameter changes (in place or by a move to
        another device)."""
        dt = self.spec.dtype
        version = tuple((p.data_ptr(), p._version) for p in self.parameters())
        key = (fine, version)
        if key not in self._packed:
            self._packed = {k: v for k, v in self._packed.items()
                            if k[1] == version}
            self._packed[key] = [
                pack_field(prepare_kernel_params_planar(net, dt),
                           () if mode is None else prepare_motion_params_planar(motion, dt),
                           net.spec, mode, self.spec.compute_dtype)
                for net, motion, mode in self.stage_fields(fine)]
        return self._packed[key]


# ---------------------------------------------------------------------------
# Render core
# ---------------------------------------------------------------------------

def _gather_boxes(scene: SceneBoxes, frame_ids: torch.Tensor) -> torch.Tensor:
    """Per-ray, per-performer box, lerped at fractional frame ids
    (ref: layered_rfrender.py:123-127,193). (N, L) -> (N, L, 2, 3), or
    (N, L, K, 2, 3) with sub-box slices (slice k lerps with slice k)."""
    F, L = scene.boxes.shape[:2]
    idx = frame_ids - 1.0
    lo = torch.clamp(torch.floor(idx), 0, F - 1)
    hi = torch.clamp(lo + 1, 0, F - 1)
    w = torch.clamp(idx - lo, 0.0, 1.0)[..., None, None]
    if scene.boxes.ndim == 5:
        w = w[..., None]
    lidx = torch.arange(L, device=frame_ids.device)[None, :]
    b_lo = scene.boxes[lo.long(), lidx]
    b_hi = scene.boxes[hi.long(), lidx]
    return (1.0 - w) * b_lo + w * b_hi


def _edit_boxes(boxes: torch.Tensor, edits: EditState) -> torch.Tensor:
    """Forward scale/shift of the layer boxes (ref: layered_rfrender.py:
    230-243). boxes (N, L+1, 2, 3) or (N, L+1, K, 2, 3)."""
    scale, shift = edits.scale[None, :, None, None], edits.shift[None, :, None, :]
    if boxes.ndim == 5:  # the slice axis
        scale, shift = scale[..., None], shift[:, :, None]
    pivot = edits.scale_pivot
    return (boxes - pivot) * scale + pivot + shift


def _inverse_edit_points(xyz: torch.Tensor, edits: EditState) -> torch.Tensor:
    """Edited-space samples back into each layer's canonical space
    (ref: layered_rfrender.py:293-303). xyz (L+1, 3, N, S)."""
    xyz = xyz - edits.shift[:, :, None, None]
    pivot = edits.scale_pivot[None, :, None, None]
    return (xyz - pivot) / edits.scale[:, None, None, None] + pivot


def _coarse_sample(spec: LayeredSpec, scene: SceneBoxes, inputs: RayInputs,
                   boxes_all: torch.Tensor, generator):
    """Coarse t's for every layer -> (t (L+1, N, S1), hit (L+1, N)).

    With sub-box slices (boxes_all (N, L+1, K, 2, 3)) a layer's interval is
    the hull [min entry, max exit] of its hit slices (``layered.py:750-790``):
    exact when the slices tile the box. With ``occ_gap_skip`` each performer
    stratifies over the union of its hit slice intervals instead."""
    N = inputs.rays_o.shape[0]
    lp1 = spec.layer_num + 1
    S1 = spec.coarse_samples
    if spec.sample_method == "NEAR_FAR":
        nf = scene.bkgd_near_far
        ts = [stratified_near_far(nf[0].expand(N), nf[1].expand(N), S1, generator)]
        ts += [stratified_near_far(inputs.near_far[:, 0], inputs.near_far[:, 1],
                                   S1, generator) for _ in range(spec.layer_num)]
        return torch.stack(ts), torch.ones((lp1, N), dtype=torch.bool,
                                           device=inputs.rays_o.device)
    if boxes_all.ndim == 5:
        K = boxes_all.shape[2]
        o_b = inputs.rays_o[:, None, None, :].expand(N, lp1, K, 3)
        d_b = inputs.rays_d[:, None, None, :].expand(N, lp1, K, 3)
        t_n, t_f, h = ray_aabb_intersect(o_b, d_b, boxes_all[..., 0, :],
                                         boxes_all[..., 1, :])  # (N, L+1, K)
        hit = h.any(2)
        t_near = torch.where(h, t_n, 3.4e38).amin(2)
        t_far = torch.where(h, t_f, -3.4e38).amax(2)
        t_near = torch.where(hit, t_near, MISS_T)
        t_far = torch.where(hit, t_far, MISS_T)
    else:
        o_b = inputs.rays_o[:, None, :].expand(N, lp1, 3)
        d_b = inputs.rays_d[:, None, :].expand(N, lp1, 3)
        t_near, t_far, hit = ray_aabb_intersect(o_b, d_b, boxes_all[..., 0, :],
                                                boxes_all[..., 1, :])  # (N, L+1)
    # background entry clamp: never start behind the camera
    # (ref: layers/RaySamplePoint.py:93-95)
    t_near = torch.cat([torch.where(t_near[:, :1] <= 0, 0.0, t_near[:, :1]),
                        t_near[:, 1:]], 1)
    if boxes_all.ndim == 5 and spec.occ_gap_skip:
        # the background's box is replicated over K: it keeps the hull
        ts = [stratified_between(t_near[:, 0], t_far[:, 0], S1, generator)]
        ts += [stratified_union(t_n[:, i], t_f[:, i], h[:, i], S1, generator)
               for i in range(1, lp1)]
    else:
        ts = [stratified_between(t_near[:, i], t_far[:, i], S1, generator)
              for i in range(lp1)]
    return torch.stack(ts), hit.T


def _tile_flags(ray_hit: torch.Tensor, S: int) -> torch.Tensor:
    """(N,) per-ray flags -> int32 per-TILE flags over the (N*S) samples."""
    hs = ray_hit[:, None].expand(-1, S).reshape(-1)
    pad = -hs.shape[0] % TILE
    if pad:
        hs = torch.cat([hs, hs.new_zeros(pad)])
    return hs.reshape(-1, TILE).any(-1).to(torch.int32)


def _eval_fields_fused(model: LayeredModel, xyz: torch.Tensor,
                       dirs_p: torch.Tensor, frame_ids: torch.Tensor,
                       fine: bool, ray_hit: torch.Tensor, plain: bool = False):
    """One fused-field launch per field (``layered.py:389-487``).

    xyz (L+1, 3, N, S) pre-deformation canonical positions, dirs_p (3, N),
    frame_ids (N, L+1), ray_hit (L+1, N) — rays that may skip a field get
    False. -> rgb (L+1, 3, N, S), sigma (L+1, N, S), raw.
    """
    spec = model.spec
    lp1, _, N, S = xyz.shape
    M = N * S
    if spec.use_dir:
        dir_enc = round_to(positional_encoding_planar(
            dirs_p, spec.spacenet_spec(bkgd=True).dir_freqs, spec.include_input),
            spec.dtype)
        dir_b = dir_enc[:, :, None].expand(-1, N, S).reshape(-1, M).contiguous()
    else:  # the packing's (1, head) zero dummy takes a zero row
        dir_b = torch.zeros((1, M), dtype=torch.float32, device=xyz.device)
    evaluate = fused_field_reference if plain else fused_field
    rgbs, sigs = [], []
    for field, x, ids, hit_l in zip(model.kernel_fields(fine), xyz,
                                    frame_ids.T, ray_hit):
        rgb, sig = evaluate(field, x.reshape(3, M),
                            ids[:, None].expand(N, S).reshape(1, M).contiguous(),
                            dir_b, _tile_flags(hit_l, S))
        rgbs.append(rgb.reshape(3, N, S))
        sigs.append(sig.reshape(N, S))
    return torch.stack(rgbs), torch.stack(sigs)


def _eval_fields_trainable(model: LayeredModel, xyz: torch.Tensor,
                           dirs_p: torch.Tensor, frame_ids: torch.Tensor,
                           fine: bool, ray_hit: torch.Tensor, plain: bool = False):
    """One differentiable field call per field (``layered.py:490-576``):
    the forward kernel, and the backward kernel when autograd runs back.
    Performers take per-tile skip flags from their bbox hits, the
    background none. Same shapes as :func:`_eval_fields_fused`."""
    spec = model.spec
    lp1, _, N, S = xyz.shape
    M = N * S
    if spec.use_dir:
        dir_enc = positional_encoding_planar(
            dirs_p, spec.spacenet_spec(bkgd=True).dir_freqs, spec.include_input,
            recursive=True)
        dir_b = dir_enc[:, :, None].expand(-1, N, S).reshape(-1, M).contiguous()
    else:
        dir_b = torch.zeros((1, M), dtype=torch.float32, device=xyz.device)
    rgbs, sigs = [], []
    for i, ((net, motion, mode), x, ids) in enumerate(zip(
            model.stage_fields(fine), xyz, frame_ids.T)):
        flags = None if i == 0 else _tile_flags(ray_hit[i], S)
        rgb, sig = field_planar_trainable(
            net, motion, x.reshape(3, M),
            ids[:, None].expand(N, S).reshape(1, M).contiguous(), dir_b, flags,
            mode, spec.compute_dtype, plain)
        rgbs.append(rgb.reshape(3, N, S))
        sigs.append(sig.reshape(N, S))
    return torch.stack(rgbs), torch.stack(sigs)


def _deform(model: LayeredModel, xyz: torch.Tensor, frame_ids: torch.Tensor,
            cam_ids: torch.Tensor) -> torch.Tensor:
    """The staged path's flows under autograd (``layered.py:696-730``), in
    the JAX package's order: the view flow on every layer with the camera
    id, then each performer's time flow with its frame id, then the
    background's. Encodings by double-angle recursion, as JAX does whenever
    the trainable kernel is on. xyz (L+1, 3, N, S) -> the same, deformed."""
    spec = model.spec
    lp1, _, N, S = xyz.shape
    dt = spec.dtype
    if model.view_deform is not None:
        ids = cam_ids[None, :, None].expand(lp1, N, S)
        flow = model.view_deform(xyz.transpose(0, 1), ids, dt, recursive=True)
        xyz = xyz + flow.transpose(0, 1)
    layers = [xyz[0]]
    for i in range(spec.layer_num):
        x = xyz[i + 1]
        if model.motion is not None:
            x = x + model.motion[i](x, frame_ids[:, i + 1, None].expand(N, S), dt,
                                    recursive=True)
        layers.append(x)
    if model.bkgd_motion is not None:
        layers[0] = layers[0] + model.bkgd_motion(
            layers[0], frame_ids[:, 0, None].expand(N, S), dt, recursive=True)
    return torch.stack(layers)


def _eval_fields_staged(model: LayeredModel, xyz: torch.Tensor,
                        dirs_p: torch.Tensor, frame_ids: torch.Tensor,
                        fine: bool, active: torch.Tensor, plain: bool = False):
    """The staged field path (JAX ``_eval_fields_trainable``,
    ``layered.py:579-642``) on deformed positions xyz (L+1, 3, N, S):
    positions and frame ids encoded here by double-angle recursion (times
    directly, not the motion net's lerp blend), directions once per ray,
    then one differentiable SpaceNet call per field
    (``spacenet_planar_trainable``), in inference as in training. No per-tile
    skip flags: a performer runs every sample unless ``active`` ((L+1,)
    bool: any ray hits it and it is shown) is False, and then the kernels
    skip it on the device and it yields zeros, as JAX's ``lax.cond``. The
    background always runs. Same outputs as :func:`_eval_fields_fused`."""
    spec = model.spec
    _, _, N, S = xyz.shape
    M = N * S
    inc = spec.include_input
    if spec.use_dir:
        dir_enc = positional_encoding_planar(
            dirs_p, spec.spacenet_spec(bkgd=True).dir_freqs, inc, recursive=True)
        dir_b = dir_enc[:, :, None].expand(-1, N, S).reshape(-1, M).contiguous()
    else:  # the packing's (1, head) zero dummy takes a zero row
        dir_b = torch.zeros((1, M), dtype=torch.float32, device=xyz.device)
    flags = active.to(torch.int32)
    rgbs, sigs = [], []
    for i, ((net, _, _), x, ids) in enumerate(zip(model.stage_fields(fine), xyz,
                                                  frame_ids.T)):
        sspec = net.spec
        pos = positional_encoding_planar(x.reshape(3, M), sspec.pos_freqs, inc,
                                         recursive=True)
        t_enc = None
        if sspec.use_time:
            t1 = positional_encoding_planar(ids[None], sspec.time_freqs, inc,
                                            recursive=True)          # (time_dim, N)
            t_enc = t1[:, :, None].expand(-1, N, S).reshape(-1, M).contiguous()
        rgb, sig = spacenet_planar_trainable(net, pos.contiguous(), dir_b, t_enc,
                                             spec.compute_dtype, plain,
                                             flags[i:i + 1] if i else None)
        rgbs.append(rgb.reshape(3, N, S))
        sigs.append(sig.reshape(N, S))
    return torch.stack(rgbs), torch.stack(sigs)


def _mask_sigma_coarse(sigma, t, hit, edits: EditState):
    """Coarse-stage zeroing (ref: layered_rfrender.py:397-418): misses and
    hidden layers, performer samples behind the origin, background samples
    before ``near``, the performer density threshold."""
    vis = (edits.visible[:, None, None] > 0) & hit[:, :, None]
    sigma = torch.where(vis, sigma, 0.0)
    bkgd = torch.where(t[0] >= edits.near, sigma[0], 0.0)
    layers = torch.where(t[1:] >= 0, sigma[1:], 0.0)
    layers = torch.where(layers < edits.density_threshold, 0.0, layers)
    return torch.cat([bkgd[None], layers], 0)


def _mask_sigma_fine(sigma, hit, edits: EditState):
    """Fine-stage zeroing (ref: layered_rfrender.py:538-576): misses and
    hidden layers, density thresholds, and the per-layer alpha fade."""
    vis = (edits.visible[:, None, None] > 0) & hit[:, :, None]
    sigma = torch.where(vis, sigma, 0.0)
    bkgd = torch.where(sigma[0] < edits.bkgd_density_threshold, 0.0, sigma[0])
    layers = torch.where(sigma[1:] < edits.density_threshold, 0.0, sigma[1:])
    return torch.cat([bkgd[None], layers], 0) * edits.alpha[:, None, None]


def _select_layers(layer_outputs, lp1: int):
    """None (or every layer) -> None; else a sorted in-range tuple."""
    if layer_outputs is None:
        return None
    sel = tuple(sorted({int(l) for l in layer_outputs if 0 <= int(l) < lp1}))
    return None if len(sel) == lp1 else sel


# the static switches a render may set apart from the model's own spec
_RENDER_SWITCHES = ("nosort_composite", "compositor_kernel", "fast_fine",
                    "coarse_exit_segments")


def _render_spec(model: LayeredModel, spec: LayeredSpec | None) -> LayeredSpec:
    """``spec`` (default: the model's) after checking that it differs from
    the model's only in :data:`_RENDER_SWITCHES`, and that it asks for no
    path this port does not have: the fast fine stage with the sort-free
    compositor is the JAX package's FAST_FINE_TRAIN path
    (``composite_streams_nosort``, ``layered.py:1013-1041``)."""
    if spec is None:
        spec = model.spec
    elif dataclasses.replace(spec, **{k: getattr(model.spec, k)
                                      for k in _RENDER_SWITCHES}) != model.spec:
        raise ValueError("a render spec may differ from the model's only in "
                         f"{', '.join(_RENDER_SWITCHES)}")
    if spec.fast_fine and spec.nosort_composite:
        raise NotImplementedError(
            "not ported to stnerf_tpu_torch yet: FAST_FINE with the sort-free "
            "compositor (the FAST_FINE_TRAIN path)")
    return spec


def _coarse_march_segmented(eval_fields, spec: LayeredSpec, xyz: torch.Tensor,
                            t_c: torch.Tensor, hit: torch.Tensor, edits: EditState):
    """The coarse march front to back in ``spec.coarse_exit_segments``
    dispatches with transmittance-driven early exit (``layered.py:800-845``).

    After each segment a layer whose own log-transmittance on a ray fell to
    ``log(coarse_exit_eps)`` or below stops evaluating that ray: the ray's
    flag goes to ``eval_fields(xyz, fine, keep)``, which makes K1's per-tile
    flags from it; skipped tiles come out as zeros, and a zero sigma has
    zero weight. The transmittance uses exactly the sigma the compositor
    sees (:func:`_mask_sigma_coarse`), and a segment's last delta closes
    against the next segment's first t. Segment bounds are Python's
    ``round(k * S1 / n_seg)``, as JAX's. At eps 0 every keep stays true and
    the segments concatenate to the single dispatch's outputs."""
    lp1, _, N, S1 = xyz.shape
    n_seg = max(1, min(spec.coarse_exit_segments, S1))
    bounds = [round(k * S1 / n_seg) for k in range(n_seg + 1)]
    eps = spec.coarse_exit_eps
    log_eps = math.log(eps) if eps > 0 else -math.inf
    keep = hit
    log_t = t_c.new_zeros((lp1, N))
    rgb_parts, sig_parts = [], []
    for k in range(n_seg):
        lo, hi = bounds[k], bounds[k + 1]
        rgb_k, sig_k = eval_fields(xyz[..., lo:hi], False, keep)
        rgb_parts.append(rgb_k)
        sig_parts.append(sig_k)
        if k + 1 < n_seg:
            t_seg = t_c[..., lo:hi]
            sig_m = _mask_sigma_coarse(sig_k, t_seg, hit, edits)
            delta = t_c[..., lo + 1:hi + 1] - t_seg
            log_t = log_t - (torch.relu(sig_m) * delta).sum(-1)
            keep = keep & (log_t > log_eps)
    return torch.cat(rgb_parts, -1), torch.cat(sig_parts, -1)


def render_rays(model: LayeredModel, scene: SceneBoxes, inputs: RayInputs,
                edits: EditState, generator: torch.Generator | None = None,
                layer_outputs=None, plain: bool = False,
                only_coarse: bool = False, trainable: bool = False,
                spec: LayeredSpec | None = None) -> RenderOutputs:
    """Render a batch of rays through all layers (``layered.py:884-1087``):
    exact reference semantics, or with the spec's inference approximations
    (the early-exit coarse march, the fast fine stage) and the scene's
    sub-box slices.

    ``generator`` None samples deterministically (bin centres, det
    ``sample_pdf``). ``layer_outputs`` (iterable of layer ids) limits which
    layers' per-layer fine composites are computed; the rest are zeros.
    ``plain`` evaluates the fields with the kernels' plain PyTorch versions
    whatever the device. ``only_coarse`` stops after the coarse stage and
    returns its composites in the fine slots too (the coarse training
    stage). ``trainable`` makes the fields differentiable wrt the model's
    parameters (:func:`_eval_fields_trainable`); the sample depths never
    are (stop-gradient, as the JAX package). With pose refinement the rays
    are moved by their camera's correction first; the bbox sampling still
    reads the unrefined rays, as the JAX package's does. With view
    deformation both stages deform the samples and take the staged path
    (:func:`_deform`, :func:`_eval_fields_staged`), trainable or not.

    ``spec`` (default ``model.spec``) may set the static switches of
    :data:`_RENDER_SWITCHES` apart from the model's, as the JAX package's
    trainer and validation render with a spec of their own. With
    ``nosort_composite`` both merges go through
    ``composite_merged_nosort``, whose cross-stream terms come from K4 and
    K5 when ``compositor_kernel`` is on (on CUDA tensors, unless ``plain``).
    A spec with FAST_FINE and ``nosort_composite`` raises.
    """
    spec = _render_spec(model, spec)
    if not trainable and torch.is_grad_enabled():
        # nothing to differentiate: the pose refinement and the staged path
        # would otherwise record a graph
        with torch.no_grad():
            return render_rays(model, scene, inputs, edits, generator, layer_outputs,
                               plain, only_coarse, spec=spec)
    N = inputs.rays_o.shape[0]
    L, lp1 = spec.layer_num, spec.layer_num + 1
    S1, S2 = spec.coarse_samples, spec.fine_samples
    bw = spec.boarder_weight

    if L:
        boxes_l = _gather_boxes(scene, inputs.frame_ids[:, 1:])
        # the background keeps one box, replicated over the slice axis
        boxes_all = torch.cat([scene.bkgd_box.expand((N, 1) + boxes_l.shape[2:]),
                               boxes_l], 1)
    else:
        boxes_all = scene.bkgd_box.expand((N, 1, 2, 3))
    boxes_all = _edit_boxes(boxes_all, edits)

    rays_o, rays_d = inputs.rays_o, inputs.rays_d
    if model.cam_pose is not None:
        rays_o, rays_d = apply_camera_transform(model.cam_pose, rays_o, rays_d,
                                                inputs.cam_ids)
    o_p, d_p = rays_o.T, rays_d.T.contiguous()
    shown = edits.visible > 0

    def eval_fields(xyz_, fine, keep):
        """keep (L+1, N): the rays each field must evaluate. The fused path
        makes K1's skip flags from it, a hidden performer costing nothing
        (the background keeps its own flags, as the JAX path does); the
        staged path skips a field no kept ray reaches, or that is hidden."""
        if spec.use_deform_view:
            xyz_ = _deform(model, xyz_, inputs.frame_ids, inputs.cam_ids)
            return _eval_fields_staged(model, xyz_, d_p, inputs.frame_ids, fine,
                                       keep.any(1) & shown, plain)
        if trainable:
            return _eval_fields_trainable(model, xyz_, d_p, inputs.frame_ids,
                                          fine, keep, plain)
        return _eval_fields_fused(model, xyz_, d_p, inputs.frame_ids, fine,
                                  torch.cat([keep[:1], keep[1:] & shown[1:, None]], 0),
                                  plain)

    # --- coarse stage ---
    t_c, hit = _coarse_sample(spec, scene, inputs, boxes_all, generator)
    t_c = t_c.detach()
    xyz = o_p[None, :, :, None] + t_c[:, None] * d_p[None, :, :, None]
    xyz = _inverse_edit_points(xyz, edits)                   # (L+1, 3, N, S1)
    if spec.coarse_exit_segments > 1:
        rgb_c, sig_c_raw = _coarse_march_segmented(eval_fields, spec, xyz, t_c, hit,
                                                   edits)
    else:
        rgb_c, sig_c_raw = eval_fields(xyz, False, hit)
    sig_c = _mask_sigma_coarse(sig_c_raw, t_c, hit, edits)
    per_layer_c = volume_render_planar(t_c, rgb_c, sig_c, bw)
    coarse_layers = LayerOutputs(per_layer_c.color, per_layer_c.depth,
                                 per_layer_c.acc)
    kernel = spec.compositor_kernel and not plain
    if spec.nosort_composite:
        mixed_c = composite_merged_nosort(t_c, rgb_c, sig_c, bw, kernel=kernel)
    else:
        mixed_c = volume_render_planar(*merge_layers_planar(t_c, rgb_c, sig_c), bw)
    coarse = LayerOutputs(mixed_c.color, mixed_c.depth, mixed_c.acc)
    if only_coarse:
        return RenderOutputs(coarse, coarse, coarse_layers, coarse_layers, hit)

    # --- fine stage: importance samples from the coarse weights ---
    w_c = per_layer_c.weights[..., 0]                            # (L+1, N, S1)
    t_flat = t_c.reshape(lp1 * N, S1)
    z_new = sample_pdf(t_flat, w_c[:, :, 1:-1].reshape(lp1 * N, S1 - 2), S2,
                       generator).detach()
    if spec.fast_fine:
        # the fine nets evaluate only the S2 new samples; the S1 coarse
        # positions carry the coarse nets' raw outputs. A performer whose
        # coarse opacity on a ray is <= fine_skip_eps skips it (its share
        # of the pixel is at most eps); the background never skips
        t_n = z_new.reshape(lp1, N, S2)
        xyz_n = o_p[None, :, :, None] + t_n[:, None] * d_p[None, :, :, None]
        xyz_n = _inverse_edit_points(xyz_n, edits)
        keep = hit & (per_layer_c.acc[..., 0] > spec.fine_skip_eps)
        rgb_n, sig_n = eval_fields(xyz_n, True, torch.cat([hit[:1], keep[1:]], 0))
        # masking is pointwise per (layer, ray): it commutes with the sort
        sig_u = _mask_sigma_fine(torch.cat([sig_c_raw, sig_n], -1), hit, edits)
        t_f, rgb_f, sig_f = sort_samples_planar(torch.cat([t_c, t_n], -1),
                                                torch.cat([rgb_c, rgb_n], -1), sig_u)
    else:
        # every union position re-evaluated through the fine nets
        t_f = sort_merge_t(t_flat, z_new).reshape(lp1, N, S1 + S2)
        xyz_f = o_p[None, :, :, None] + t_f[:, None] * d_p[None, :, :, None]
        xyz_f = _inverse_edit_points(xyz_f, edits)
        rgb_f, sig_f = eval_fields(xyz_f, True, hit)
        sig_f = _mask_sigma_fine(sig_f, hit, edits)

    sel = _select_layers(layer_outputs, lp1)
    if sel is None:
        p = volume_render_planar(t_f, rgb_f, sig_f, bw)
        fine_layers = LayerOutputs(p.color, p.depth, p.acc)
    else:
        idx = list(sel)
        zc = t_f.new_zeros((lp1, N, 3))
        z1 = t_f.new_zeros((lp1, N, 1))
        fine_layers = LayerOutputs(zc, z1, z1.clone())
        if idx:
            p = volume_render_planar(t_f[idx], rgb_f[idx], sig_f[idx], bw)
            fine_layers.color[idx] = p.color
            fine_layers.depth[idx] = p.depth
            fine_layers.acc[idx] = p.acc

    if spec.nosort_composite:
        sig_fc = torch.where(t_f >= edits.near, sig_f, 0.0)   # ref: :605
        mixed_f = composite_merged_nosort(t_f, rgb_f, sig_fc, bw, kernel=kernel)
    else:
        t_mf, rgb_mf, sig_mf = merge_layers_planar(t_f, rgb_f, sig_f)
        sig_mf = torch.where(t_mf >= edits.near, sig_mf, 0.0)  # ref: :605
        mixed_f = volume_render_planar(t_mf, rgb_mf, sig_mf, bw)
    fine = LayerOutputs(mixed_f.color, mixed_f.depth, mixed_f.acc)
    return RenderOutputs(fine, coarse, fine_layers, coarse_layers, hit)
