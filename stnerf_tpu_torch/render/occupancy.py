"""Occupancy-driven empty-space skipping: tighten the scene's boxes to where
the trained fields have density. Counterpart of
``stnerf_tpu/render/occupancy.py``.

Each performer's field (and optionally the background's) is evaluated on a
``grid``^3 lattice inside its box once per frame, through the field kernel
K1 on a card (``kernels.fused_field``, its plain version on the CPU):
zero directions, the frame id as time, the layer's MotionNet as the render
path runs it. The relu(sigma) cube, the max over the coarse and fine nets
cast to float16 as the JAX package casts it, is thresholded on the host
and each box shrinks to the hull of its occupied voxels (one dilation voxel
of slack). ``slices > 1`` splits each box into sub-boxes along the layer's
dominant occupied axis (``SceneBoxes.boxes`` (F, L, K, 2, 3)); the sampler
intersects their union (``models/layered._coarse_sample``). ``tau = 0``
is exact: every voxel is occupied, each box comes back as it was, and the
slices tile it. With ``auto_tau_db`` each (layer, frame) takes the largest
threshold whose culled voxels' worst-case per-ray alpha keeps the image
above that PSNR (:func:`auto_tau`).

The host NumPy (:func:`_extent_from_cube` to :func:`auto_slice_tau`,
:func:`_shrink`, :func:`_slice_boxes`) is a copy of the JAX package's, so
both give the same boxes from the same cube. Cached boxes carry a file name
prefix of their own (``occ_boxes_torch_``), so that neither package renders
with boxes the other refined.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from ..kernels.fused_field import fused_field, fused_field_reference
from ..models.layered import LayeredModel, SceneBoxes
from ..ops.encoding import positional_encoding_planar
from ..ops.rounding import round_to

logger = logging.getLogger("stnerf_tpu_torch.render.occupancy")


def _grid_points(box: torch.Tensor, grid: int) -> torch.Tensor:
    """Voxel-centre world coordinates for a (2, 3) box -> (3, G, G, G)."""
    lo, hi = box[0], box[1]
    centers = (torch.arange(grid, dtype=torch.float32, device=box.device) + 0.5) / grid
    axes = [lo[a] + centers * (hi[a] - lo[a]) for a in range(3)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"))


def _extent_from_cube(occ: np.ndarray):
    """Host: (lo_idx (3,), hi_idx (3,), any_occ) of a bool cube's occupied
    span along each axis."""
    if not occ.any():
        return np.zeros(3, np.int64), np.zeros(3, np.int64), False
    los, his = [], []
    for axis in range(3):
        line = occ.any(axis=tuple(a for a in range(3) if a != axis))
        idx = np.nonzero(line)[0]
        los.append(idx[0])
        his.append(idx[-1])
    return np.asarray(los), np.asarray(his), True


def _eps_alpha(min_db: float) -> float:
    """Map a PSNR floor to a per-ray culled-alpha budget. Removing matter
    with total alpha a changes a pixel by at most ~2a (its own emission is
    gone and everything behind it brightens by the freed transmittance),
    so worst-case RMSE <= 2a; PSNR >= min_db needs 2a <= 10^(-min_db/20)."""
    return 0.5 * 10.0 ** (-float(min_db) / 20.0)


def _culled_alpha_bound(sig: np.ndarray, keep: np.ndarray, box: np.ndarray,
                        grid: int) -> float:
    """Upper bound on ANY ray's alpha contribution from the culled voxels
    (``~keep``), from the sigma lattice itself.

    For a ray with dominant axis a (|d_a| >= 1/sqrt(3)), its path length
    inside one slab perpendicular to a is voxel_a/|d_a| <= sqrt(3)*voxel_a,
    and the sigma it sees there is at most the slab's max culled sigma; so
    the optical depth is <= sqrt(3)*voxel_a*sum_k max(culled sigma in slab
    k). Taking the max over the three axes covers every ray direction, and
    alpha = 1 - exp(-depth).
    """
    s = np.where(keep, 0.0, np.asarray(sig, np.float32))
    voxel = (np.asarray(box[1], np.float64) - np.asarray(box[0])) / grid
    depth = 0.0
    for a in range(3):
        other = tuple(x for x in range(3) if x != a)
        depth = max(depth, float(voxel[a]) * float(s.max(axis=other).sum()))
    return float(-np.expm1(-np.sqrt(3.0) * depth))


def _hull_keep_mask(occ: np.ndarray, grid: int, pad: int) -> np.ndarray:
    """Bool cube marking voxels inside the (padded) bounding hull of occ."""
    lo_i, hi_i, any_occ = _extent_from_cube(occ)
    keep = np.zeros(occ.shape, bool)
    if any_occ:
        lo = np.maximum(lo_i - pad, 0)
        hi = np.minimum(hi_i + pad, grid - 1)
        keep[lo[0]:hi[0] + 1, lo[1]:hi[1] + 1, lo[2]:hi[2] + 1] = True
    return keep


def _boxes_keep_mask(box: np.ndarray, sub_boxes: np.ndarray,
                     grid: int) -> np.ndarray:
    """Bool cube marking voxels of ``box``'s lattice whose centers fall in
    any of the (K, 2, 3) world ``sub_boxes``."""
    lo, hi = np.asarray(box[0], np.float64), np.asarray(box[1], np.float64)
    centers = [lo[a] + (np.arange(grid) + 0.5) * (hi[a] - lo[a]) / grid
               for a in range(3)]
    keep = np.zeros((grid,) * 3, bool)
    for sb in np.asarray(sub_boxes, np.float64):
        ins = [(centers[a] >= sb[0, a]) & (centers[a] <= sb[1, a])
               for a in range(3)]
        keep |= ins[0][:, None, None] & ins[1][None, :, None] & ins[2][None, None, :]
    return keep


def auto_tau(sig: np.ndarray, box: np.ndarray, grid: int, pad: int,
             eps_alpha: float) -> tuple[float, float]:
    """Largest occupancy threshold whose culled-voxel worst-case per-ray
    alpha (:func:`_culled_alpha_bound` over the hull complement) stays under
    ``eps_alpha`` -> (tau, bound). tau = 0.0 (exact: every voxel occupied,
    box round-trips) when even the smallest candidate violates the budget.

    The bound is monotone in tau (larger tau culls a superset), so the
    descending sweep returns the first — largest — admissible candidate.
    """
    sig = np.asarray(sig, np.float32)
    smax = float(sig.max())
    if not np.isfinite(smax) or smax <= 0.0:
        return 0.0, 0.0
    cands = np.geomspace(max(smax, 1e-3), 1e-3, 40)  # descending

    def bound_at(tau):
        return _culled_alpha_bound(
            sig, _hull_keep_mask(sig >= tau, grid, pad), box, grid)

    # culled set grows with tau, so admissibility (bound <= eps) flips once
    # from False to True as tau descends: binary-search the flip point
    left, right = 0, len(cands)
    while left < right:
        mid = (left + right) // 2
        if bound_at(cands[mid]) <= eps_alpha:
            right = mid
        else:
            left = mid + 1
    if left == len(cands):
        return 0.0, 0.0
    return float(cands[left]), bound_at(cands[left])


def auto_slice_tau(sig: np.ndarray, box: np.ndarray, axis: int, slices: int,
                   grid: int, pad: int, eps_alpha: float):
    """Largest tau whose K-sub-box culling (:func:`_slice_boxes` on the
    ``sig >= tau`` cube) keeps the worst-case per-ray culled alpha within
    ``eps_alpha`` -> (sub_boxes (K, 2, 3), tau, bound), or (None, 0, inf).

    Searched independently of the hull tau: per-slice extents tighten along
    EVERY axis, so slicing culls far more volume at a given threshold than
    the hull trim does, and the hull-admissible tau is usually far too
    aggressive for slicing. A descending linear scan (40 candidates) keeps
    correctness even where sub-box geometry makes the bound non-monotone.
    """
    sig = np.asarray(sig, np.float32)
    smax = float(sig.max())
    if not np.isfinite(smax) or smax <= 0.0:
        return None, 0.0, float("inf")
    for tau in np.geomspace(max(smax, 1e-3), 1e-3, 40):
        occ = sig >= tau
        if not occ.any():
            continue
        sub = _slice_boxes(box, occ, axis, slices, grid, pad)
        keep = _boxes_keep_mask(box, sub, grid)
        bound = _culled_alpha_bound(sig, keep, box, grid)
        if bound <= eps_alpha:
            return sub, float(tau), float(bound)
    return None, 0.0, float("inf")


@torch.no_grad()
def _occupancy_cube(model: LayeredModel, field: int, box: np.ndarray,
                    frame_id: float, grid: int, plain: bool = False) -> np.ndarray:
    """relu(sigma) of field ``field`` (0 the background, i performer i) on
    the ``grid``^3 lattice inside ``box`` (2, 3) at ``frame_id`` -> a (G, G,
    G) float32 cube of float16 values (``occupancy.py:192-227``).

    One K1 launch per net (``plain``: its plain version) on the packed
    fields the render path runs, with zero directions and the frame id as
    time; a performer's MotionNet runs in the "lerp" mode, which equals
    "direct" at the integer ids used here. The max over the coarse and fine
    nets (the coarse alone with SAME_SPACENET, as JAX's): the refined box
    must hold what either stage sees."""
    spec = model.spec
    device = next(model.parameters()).device
    xyz = _grid_points(torch.as_tensor(box, dtype=torch.float32, device=device),
                       grid).reshape(3, -1)
    m = xyz.shape[1]
    ids = torch.full((1, m), float(frame_id), device=device)
    if spec.use_dir:
        enc = positional_encoding_planar(torch.zeros((3, 1), device=device),
                                         spec.spacenet_spec(bkgd=True).dir_freqs,
                                         spec.include_input)
        dir_enc = round_to(enc, spec.dtype).expand(-1, m).contiguous()
    else:
        dir_enc = torch.zeros((1, m), device=device)
    evaluate = fused_field_reference if plain else fused_field
    sig = None
    for fine in ((False,) if spec.same_spacenet else (False, True)):
        _, s = evaluate(model.kernel_fields(fine)[field], xyz, ids, dir_enc)
        s = torch.relu(s)                      # the compositor sees relu(sigma)
        sig = s if sig is None else torch.maximum(sig, s)
    return sig.half().cpu().numpy().astype(np.float32).reshape(grid, grid, grid)


def _shrink(box: np.ndarray, lo_idx, hi_idx, grid: int, pad: int) -> np.ndarray:
    """Host: occupied index span -> world sub-box, dilated and clamped."""
    lo, hi = box[0], box[1]
    voxel = (hi - lo) / grid
    new_lo = np.maximum(lo, lo + (np.asarray(lo_idx) - pad) * voxel)
    new_hi = np.minimum(hi, lo + (np.asarray(hi_idx) + 1 + pad) * voxel)
    return np.stack([new_lo, new_hi]).astype(np.float32)


def _slice_boxes(box: np.ndarray, occ: np.ndarray, axis: int, slices: int,
                 grid: int, pad: int) -> np.ndarray:
    """Host: split ``box``'s occupied span along ``axis`` into ``slices``
    index chunks and tighten each chunk's cross-axes extent -> (K, 2, 3).

    An empty chunk collapses to a zero-volume point box (slab test misses it;
    ``t_far > t_near`` is false at zero extent), placed at the chunk's center
    so fractional-frame box lerp stays local.
    """
    lo_i, hi_i, _ = _extent_from_cube(occ)
    span0, span1 = int(lo_i[axis]), int(hi_i[axis]) + 1
    bounds = np.linspace(span0, span1, slices + 1).round().astype(int)
    out = np.empty((slices, 2, 3), np.float32)
    for k in range(slices):
        a, b = bounds[k], max(bounds[k + 1], bounds[k] + 1)
        sub = np.take(occ, np.arange(a, min(b, grid)), axis=axis)
        s_lo, s_hi, any_occ = _extent_from_cube(sub)
        if any_occ:
            s_lo = s_lo.copy()
            s_hi = s_hi.copy()
            s_lo[axis] += a
            s_hi[axis] += a
            out[k] = _shrink(box, s_lo, s_hi, grid, pad)
        else:
            center = 0.5 * (_shrink(box, lo_i, hi_i, grid, pad).sum(0))
            voxel = (box[1] - box[0]) / grid
            center[axis] = box[0, axis] + 0.5 * (a + b) * voxel[axis]
            out[k] = np.stack([center, center])
    return out


def refine_scene_boxes(model: LayeredModel, scene: SceneBoxes, grid: int = 64,
                       sigma_thresh: float = 1.0, pad_voxels: int = 1,
                       refine_bkgd: bool = False, slices: int = 1,
                       auto_tau_db: float | None = None) -> SceneBoxes:
    """``scene`` with each per-frame performer box (and, with
    ``refine_bkgd``, the background box) shrunk to the trained field's
    occupied region (``occupancy.py:289-436``).

    ``slices > 1`` also splits each box into ``slices`` sub-boxes along the
    layer's dominant occupied axis (chosen once per layer so that slices
    correspond across frames for the fractional-frame lerp): the boxes come
    back (F, L, K, 2, 3). Degenerate rows (zero boxes of FRAME_OFFSET
    padding) and layers with nothing above the threshold keep their box.

    ``auto_tau_db``: ``sigma_thresh`` is ignored and each (layer, frame)
    gets the largest tau whose culled voxels' worst-case per-ray alpha
    keeps the image above ``auto_tau_db`` dB, the budget split evenly over
    the refined fields (a ray can cross every one of them); with slices the
    union of sub-boxes is re-checked against the same budget per frame, and
    a frame where no tau fits keeps its hull box on every slice.
    """
    orig = scene.boxes.cpu().numpy()
    boxes = orig.copy()                              # (F, L, 2, 3)
    F, L = boxes.shape[:2]
    K = max(1, int(slices))
    n_fields = max(L + (1 if refine_bkgd else 0), 1)
    eps = (_eps_alpha(auto_tau_db) / n_fields
           if auto_tau_db is not None else None)
    shrunk = total = 0
    taus: list[float] = []
    vol = lambda b: float(np.prod(np.maximum(b[1] - b[0], 0.0)))
    # default: original box replicated across slices (exact union)
    sliced = np.repeat(boxes[:, :, None], K, axis=2)  # (F, L, K, 2, 3)

    def pick_tau(sig, box):
        if eps is None:
            return float(sigma_thresh)
        tau, _ = auto_tau(sig, box, grid, pad_voxels, eps)
        taus.append(tau)
        return tau

    for layer in range(1, L + 1):
        cubes: dict[int, np.ndarray] = {}
        sigs: dict[int, np.ndarray] = {}
        for f in range(F):
            box = boxes[f, layer - 1]
            if not np.all(box[1] > box[0]):
                continue                             # FRAME_OFFSET zero row
            total += 1
            sig = _occupancy_cube(model, layer, box, f + 1, grid)
            tau_f = pick_tau(sig, box)
            occ = sig >= tau_f
            lo_i, hi_i, any_occ = _extent_from_cube(occ)
            if not any_occ:
                logger.warning(
                    "occupancy: layer %d frame %d has no sigma >= %.3g; "
                    "keeping the original box", layer, f + 1, tau_f)
                continue
            new = _shrink(box, lo_i, hi_i, grid, pad_voxels)
            if vol(new) < vol(box):
                shrunk += 1
            boxes[f, layer - 1] = new
            if K > 1:
                cubes[f] = occ
                sigs[f] = sig
        if K > 1 and cubes:
            # dominant occupied axis, summed in world units over frames
            lengths = np.zeros(3)
            for f, occ in cubes.items():
                lo_i, hi_i, _ = _extent_from_cube(occ)
                voxel = (orig[f, layer - 1, 1] - orig[f, layer - 1, 0]) / grid
                lengths += (hi_i - lo_i + 1) * voxel
            axis = int(np.argmax(lengths))
            for f, occ in cubes.items():
                box = orig[f, layer - 1]
                if eps is None:
                    sliced[f, layer - 1] = _slice_boxes(box, occ, axis, K, grid,
                                                        pad_voxels)
                    continue
                sub, tau_s, bound = auto_slice_tau(sigs[f], box, axis, K, grid,
                                                   pad_voxels, eps)
                if sub is None:
                    logger.info(
                        "occupancy: layer %d frame %d: no slice tau fits "
                        "budget %.2e; keeping hull box", layer, f + 1, eps)
                    sliced[f, layer - 1] = np.repeat(boxes[f, layer - 1][None], K, axis=0)
                    continue
                logger.info(
                    "occupancy: layer %d frame %d sliced at tau %.3g "
                    "(culling bound %.2e <= %.2e)", layer, f + 1, tau_s, bound, eps)
                sliced[f, layer - 1] = sub

    bkgd_box = scene.bkgd_box.cpu().numpy()
    if refine_bkgd:
        sig = _occupancy_cube(model, 0, bkgd_box, 1.0, grid)
        tau_b = pick_tau(sig, bkgd_box)
        lo_i, hi_i, any_occ = _extent_from_cube(sig >= tau_b)
        if any_occ:
            bkgd_box = _shrink(bkgd_box, lo_i, hi_i, grid, pad_voxels)

    if total:
        if eps is not None and taus:
            logger.info(
                "occupancy: tightened %d/%d performer boxes (grid %d, "
                "auto tau %.3g..%.3g for >= %.1f dB worst case, slices %d)",
                shrunk, total, grid, min(taus), max(taus), auto_tau_db, K)
        else:
            logger.info("occupancy: tightened %d/%d performer boxes "
                        "(grid %d, tau %.3g, slices %d)", shrunk, total,
                        grid, sigma_thresh, K)
    device = scene.boxes.device
    return SceneBoxes(torch.as_tensor(bkgd_box, device=device),
                      torch.as_tensor(sliced if K > 1 else boxes, device=device),
                      scene.bkgd_near_far)


def refined_boxes_cached(model: LayeredModel, scene: SceneBoxes, cache_dir: str,
                         ckpt_path: str | None, grid: int = 64,
                         sigma_thresh: float = 1.0, pad_voxels: int = 1,
                         refine_bkgd: bool = False, slices: int = 1,
                         auto_tau_db: float | None = None) -> SceneBoxes:
    """Disk-cached :func:`refine_scene_boxes` (``occupancy.py:438-481``).

    The cache key covers the checkpoint (file name and mtime) and every
    refinement knob, as the JAX package's does, so retraining or re-tuning
    never serves stale boxes; the name starts ``occ_boxes_torch_``.
    """
    tag = "none"
    if ckpt_path and os.path.exists(ckpt_path):
        tag = f"{os.path.basename(ckpt_path)}_{int(os.path.getmtime(ckpt_path))}"
    # "a2": auto-tau semantics v2 (the per-ray budget split across fields,
    # slices searching their own tau), as the JAX package names it
    thresh_tag = (f"a2{auto_tau_db:g}" if auto_tau_db is not None
                  else f"{sigma_thresh:g}")
    name = (f"occ_boxes_torch_{tag}_g{grid}_t{thresh_tag}_p{pad_voxels}"
            f"_b{int(refine_bkgd)}" + (f"_k{slices}" if slices > 1 else "") + ".npz")
    path = os.path.join(cache_dir, name)
    device = scene.boxes.device
    if os.path.exists(path):
        data = np.load(path)
        logger.info("occupancy: loaded cached boxes %s", path)
        return SceneBoxes(torch.as_tensor(data["bkgd_box"], device=device),
                          torch.as_tensor(data["boxes"], device=device),
                          scene.bkgd_near_far)
    t0 = time.perf_counter()
    refined = refine_scene_boxes(model, scene, grid=grid, sigma_thresh=sigma_thresh,
                                 pad_voxels=pad_voxels, refine_bkgd=refine_bkgd,
                                 slices=slices, auto_tau_db=auto_tau_db)
    logger.info("occupancy: refined boxes in %.4f s", time.perf_counter() - t0)
    try:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez(path, bkgd_box=refined.bkgd_box.cpu().numpy(),
                 boxes=refined.boxes.cpu().numpy())
        logger.info("occupancy: cached boxes -> %s", path)
    except OSError:
        pass
    return refined
