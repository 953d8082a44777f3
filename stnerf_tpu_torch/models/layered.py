"""The layered spatio-temporal radiance field and its exact render core.

Counterpart of ``stnerf_tpu/models/layered.py`` (ref:
modeling/layered_rfrender.py:19-735) on its exact inference path: a
background field plus L performer fields, each a SpaceNet with a per-layer
MotionNet; BBOX or NEAR_FAR coarse sampling, ``sample_pdf`` fine
resampling over the union of coarse and new samples, and the depth-sorted
merge of every layer's samples. Edits (hide/show, shift, scale, alpha,
near clip, density thresholds) are data in :class:`EditState`.

Every field evaluation goes through ``kernels.fused_field``: the hand-
written CUDA kernel on the card, its plain PyTorch version on the CPU (or
anywhere with ``plain=True``). Per-ray bbox hits become the kernel's
per-tile skip flags; a performer that is hidden, or that no ray of the
batch hits, gets all-zero flags, so every block of its launch exits at
once without a host round trip. For training (``render_rays(...,
trainable=True)``) each field goes through
``kernels.field_vjp.field_planar_trainable`` instead: the same forward
kernel, and the backward kernel ``field_bwd``.

Not ported yet (``LayeredSpec`` refuses them): the fast fine stage, the
early-exit coarse march, the sort-free compositor, view deformation, pose
refinement and occupancy sub-box slices.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import NamedTuple

import torch
from torch import nn

from ..device import resolve_device
from ..kernels.field_vjp import field_planar_trainable
from ..kernels.fused_field import (TILE, PackedField, fused_field,
                                   fused_field_reference, pack_field,
                                   prepare_kernel_params_planar,
                                   prepare_motion_params_planar)
from ..ops.encoding import positional_encoding_planar
from ..ops.rounding import round_to
from ..ops.sampling import (ray_aabb_intersect, sample_pdf,
                            stratified_between, stratified_near_far)
from ..ops.volume import (merge_layers_planar, sort_merge_t,
                          volume_render_planar)
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
    deep_rgb: bool = False
    backbone_dim: int = 256
    head_dim: int = 128
    motion_dim: int = 128
    compute_dtype: str = "float32"     # "bfloat16" | "float32"
    # paths of the JAX package this port does not have yet; any of them on
    # is refused rather than silently rendered another way
    use_deform_view: bool = False
    pose_refinement: bool = False
    nosort_composite: bool = False
    fast_fine: bool = False
    coarse_exit_segments: int = 0
    occ_gap_skip: bool = False

    def __post_init__(self):
        unported = {"USE_DEFORM_VIEW": self.use_deform_view,
                    "POSE_REFINEMENT": self.pose_refinement,
                    "nosort_composite": self.nosort_composite,
                    "FAST_FINE": self.fast_fine,
                    "EARLY_EXIT_SEGMENTS > 1": self.coarse_exit_segments > 1,
                    "OCC_GAP_SKIP": self.occ_gap_skip}
        on = [k for k, v in unported.items() if v]
        if on:
            raise NotImplementedError(
                f"not ported to stnerf_tpu_torch yet: {', '.join(on)}")
        if self.sample_method not in ("BBOX", "NEAR_FAR"):
            raise ValueError(f"unknown SAMPLE_METHOD {self.sample_method!r}")
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"unknown COMPUTE_DTYPE {self.compute_dtype!r}")

    @classmethod
    def from_cfg(cls, cfg) -> "LayeredSpec":
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
            # matches ref: modeling/layered_rfrender.py:35
            deep_rgb=(m.DEEP_RGB and m.USE_SPACE_TIME),
            backbone_dim=m.BACKBONE_DIM,
            head_dim=m.HEAD_DIM,
            motion_dim=m.MOTION_DIM,
            compute_dtype=cfg.TPU.COMPUTE_DTYPE,
            use_deform_view=m.USE_DEFORM_VIEW,
            pose_refinement=m.POSE_REFINEMENT,
            fast_fine=cfg.TPU.FAST_FINE,
            coarse_exit_segments=int(cfg.TPU.EARLY_EXIT_SEGMENTS),
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
    boxes: torch.Tensor          # (F, L, 2, 3) per-frame performer boxes
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
    motion net. The model lands on ``device``: the CUDA card unless the
    caller names another (``device="cpu"``).
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
    (ref: layered_rfrender.py:123-127,193). (N, L) -> (N, L, 2, 3)."""
    F, L = scene.boxes.shape[:2]
    idx = frame_ids - 1.0
    lo = torch.clamp(torch.floor(idx), 0, F - 1)
    hi = torch.clamp(lo + 1, 0, F - 1)
    w = torch.clamp(idx - lo, 0.0, 1.0)[..., None, None]
    lidx = torch.arange(L, device=frame_ids.device)[None, :]
    b_lo = scene.boxes[lo.long(), lidx]
    b_hi = scene.boxes[hi.long(), lidx]
    return (1.0 - w) * b_lo + w * b_hi


def _edit_boxes(boxes: torch.Tensor, edits: EditState) -> torch.Tensor:
    """Forward scale/shift of the layer boxes (ref: layered_rfrender.py:
    230-243). boxes (N, L+1, 2, 3)."""
    pivot = edits.scale_pivot
    boxes = (boxes - pivot) * edits.scale[None, :, None, None] + pivot
    return boxes + edits.shift[None, :, None, :]


def _inverse_edit_points(xyz: torch.Tensor, edits: EditState) -> torch.Tensor:
    """Edited-space samples back into each layer's canonical space
    (ref: layered_rfrender.py:293-303). xyz (L+1, 3, N, S)."""
    xyz = xyz - edits.shift[:, :, None, None]
    pivot = edits.scale_pivot[None, :, None, None]
    return (xyz - pivot) / edits.scale[:, None, None, None] + pivot


def _coarse_sample(spec: LayeredSpec, scene: SceneBoxes, inputs: RayInputs,
                   boxes_all: torch.Tensor, generator):
    """Coarse t's for every layer -> (t (L+1, N, S1), hit (L+1, N))."""
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
    o_b = inputs.rays_o[:, None, :].expand(N, lp1, 3)
    d_b = inputs.rays_d[:, None, :].expand(N, lp1, 3)
    t_near, t_far, hit = ray_aabb_intersect(o_b, d_b, boxes_all[..., 0, :],
                                            boxes_all[..., 1, :])  # (N, L+1)
    # background entry clamp: never start behind the camera
    # (ref: layers/RaySamplePoint.py:93-95)
    t_near = torch.cat([torch.where(t_near[:, :1] <= 0, 0.0, t_near[:, :1]),
                        t_near[:, 1:]], 1)
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


def render_rays(model: LayeredModel, scene: SceneBoxes, inputs: RayInputs,
                edits: EditState, generator: torch.Generator | None = None,
                layer_outputs=None, plain: bool = False,
                only_coarse: bool = False, trainable: bool = False) -> RenderOutputs:
    """Render a batch of rays through all layers, exact reference
    semantics (``layered.py:884-1087``, the exact fine branch).

    ``generator`` None samples deterministically (bin centres, det
    ``sample_pdf``). ``layer_outputs`` (iterable of layer ids) limits which
    layers' per-layer fine composites are computed; the rest are zeros.
    ``plain`` evaluates the fields with the kernels' plain PyTorch versions
    whatever the device. ``only_coarse`` stops after the coarse stage and
    returns its composites in the fine slots too (the coarse training
    stage). ``trainable`` makes the fields differentiable wrt the model's
    parameters (:func:`_eval_fields_trainable`); the sample depths never
    are (stop-gradient, as the JAX package).
    """
    spec = model.spec
    N = inputs.rays_o.shape[0]
    L, lp1 = spec.layer_num, spec.layer_num + 1
    S1, S2 = spec.coarse_samples, spec.fine_samples
    bw = spec.boarder_weight
    if scene.boxes.ndim != 4:
        raise NotImplementedError("occupancy sub-box slices are not ported to "
                                  "stnerf_tpu_torch yet")

    bshape = (N, 1, 2, 3)
    boxes_all = scene.bkgd_box.expand(bshape)
    if L:
        boxes_all = torch.cat([boxes_all,
                               _gather_boxes(scene, inputs.frame_ids[:, 1:])], 1)
    boxes_all = _edit_boxes(boxes_all, edits)

    o_p, d_p = inputs.rays_o.T, inputs.rays_d.T.contiguous()

    def eval_fields(xyz_, fine):
        if trainable:
            return _eval_fields_trainable(model, xyz_, d_p, inputs.frame_ids,
                                          fine, hit, plain)
        return _eval_fields_fused(model, xyz_, d_p, inputs.frame_ids, fine,
                                  ray_hit, plain)

    # --- coarse stage ---
    t_c, hit = _coarse_sample(spec, scene, inputs, boxes_all, generator)
    t_c = t_c.detach()
    # kernel skip flags: a hidden performer costs nothing (the background
    # keeps its bbox flags, as the JAX path does)
    shown = edits.visible > 0
    ray_hit = torch.cat([hit[:1], hit[1:] & shown[1:, None]], 0)
    xyz = o_p[None, :, :, None] + t_c[:, None] * d_p[None, :, :, None]
    xyz = _inverse_edit_points(xyz, edits)                   # (L+1, 3, N, S1)
    rgb_c, sig_c = eval_fields(xyz, False)
    sig_c = _mask_sigma_coarse(sig_c, t_c, hit, edits)
    per_layer_c = volume_render_planar(t_c, rgb_c, sig_c, bw)
    coarse_layers = LayerOutputs(per_layer_c.color, per_layer_c.depth,
                                 per_layer_c.acc)
    mixed_c = volume_render_planar(*merge_layers_planar(t_c, rgb_c, sig_c), bw)
    coarse = LayerOutputs(mixed_c.color, mixed_c.depth, mixed_c.acc)
    if only_coarse:
        return RenderOutputs(coarse, coarse, coarse_layers, coarse_layers, hit)

    # --- fine stage: importance samples folded into the coarse set, every
    # union position re-evaluated through the fine nets ---
    w_c = per_layer_c.weights[..., 0]                            # (L+1, N, S1)
    t_flat = t_c.reshape(lp1 * N, S1)
    z_new = sample_pdf(t_flat, w_c[:, :, 1:-1].reshape(lp1 * N, S1 - 2), S2,
                       generator).detach()
    t_f = sort_merge_t(t_flat, z_new).reshape(lp1, N, S1 + S2)
    xyz_f = o_p[None, :, :, None] + t_f[:, None] * d_p[None, :, :, None]
    xyz_f = _inverse_edit_points(xyz_f, edits)
    rgb_f, sig_f = eval_fields(xyz_f, True)
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

    t_mf, rgb_mf, sig_mf = merge_layers_planar(t_f, rgb_f, sig_f)
    sig_mf = torch.where(t_mf >= edits.near, sig_mf, 0.0)     # ref: :605
    mixed_f = volume_render_planar(t_mf, rgb_mf, sig_mf, bw)
    fine = LayerOutputs(mixed_f.color, mixed_f.depth, mixed_f.acc)
    return RenderOutputs(fine, coarse, fine_layers, coarse_layers, hit)
