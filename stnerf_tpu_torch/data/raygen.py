"""Training-ray pregeneration with on-disk caching — the port's copy of
``stnerf_tpu/data/raygen.py``: the same pools, caches and file names, and
the same draws from the numpy ``Generator`` in the same order, so the same
seed gives the same pool.

Host-side counterpart of the reference's ``Ray_Frame_Layer_Dataset`` /
``Ray_Dataset`` pipeline (ref: data/datasets/ray_dataset.py:339-455, 13-83):
for every (layer, frame) it walks the cameras, selects pixels — by
segmentation id when a label map is used, else by the projected-bbox ROI —
converts them to packed rays (+ camera/frame id columns per model flags),
shuffles and subsamples (background keeps ``BKGD_SAMPLE_RATE``), and caches
flat arrays to ``{TMP_RAYS}/frame{F}/layer{L}/rays.npz``. The flat ray pool
is exactly what a device input pipeline wants: fixed-size random batches with
zero per-step host work.
"""

from __future__ import annotations

import hashlib
import logging
import multiprocessing
import os

import numpy as np

logger = logging.getLogger(__name__)

from .cameras import pixel_rays_at, project_bbox_roi
from .scene import FrameLayerScene, corners_from_minmax


def _select_pixels(image, label, K, T, layer_id: int, bbox,
                   use_label_map: bool, rate: float = 1.0,
                   rng: np.random.Generator | None = None):
    """Pixel selection for one camera — the compact core.

    use_label_map: keep pixels whose segmentation == layer_id
    (ref: utils/ray_sampling.py:194-240). Otherwise: keep the projected-bbox
    ROI crop with its labels (ref: utils/ray_sampling.py:75-192).
    Returns (pix (N,) uint32 flat indices, labels (N,) uint8, rgbs (N,3)
    uint8) — no ray arithmetic; rays are reconstructed from (cam, pix) by
    the device decoder (engine/trainer.make_decode) or
    :func:`decode_pool_host`.

    ``rate < 1`` subsamples the kept pixel set here. The reference
    subsamples the concatenated all-camera pool instead
    (ref: ray_dataset.py:429-439) — per-camera sampling draws from the same
    distribution at ~1/rate less host work, which dominates pregeneration
    wall-clock for background layers (BKGD_SAMPLE_RATE ≈ 0.05 at 1080p).
    """
    _, H, W = image.shape
    lab_flat = label.reshape(-1)

    if use_label_map:
        keep_idx = np.flatnonzero(lab_flat == layer_id)
    else:
        roi = (project_bbox_roi(corners_from_minmax(bbox[0], bbox[1]), K, T, H, W)
               if bbox is not None else (0, H, 0, W))
        minh, maxh, minw, maxw = roi
        vs, us = np.meshgrid(np.arange(minh, maxh), np.arange(minw, maxw),
                             indexing="ij")
        keep_idx = (vs * W + us).reshape(-1)

    if rate < 1.0 and keep_idx.size:
        n_keep = int(keep_idx.size * rate)
        keep_idx = (rng or np.random.default_rng()).choice(
            keep_idx, size=n_keep, replace=False)
        keep_idx.sort()

    # planar gather: no full-image HWC copy; re-quantize the float image
    # (identity transform: float == uint8/255, so this is exact)
    rgbs = (image.reshape(3, -1)[:, keep_idx].T * 255.0 + 0.5).astype(np.uint8)
    return (keep_idx.astype(np.uint32), lab_flat[keep_idx].astype(np.uint8),
            np.ascontiguousarray(rgbs))


def _select_rays(image, label, K, T, layer_id: int, bbox, use_label_map: bool,
                 rate: float = 1.0, rng: np.random.Generator | None = None):
    """f32 variant of :func:`_select_pixels` for the legacy pool format
    (kept for randomly-augmented transforms, whose per-sample warped K
    cannot be captured by the compact per-camera tables).
    Returns (rays (N,6), labels (N,1), rgbs (N,3) f32) — rgbs gathered from
    the float image directly (warped pixels are not uint8-exact)."""
    _, H, W = image.shape
    keep_idx, labels, _ = _select_pixels(image, label, K, T, layer_id,
                                         bbox, use_label_map, rate, rng)
    idx = keep_idx.astype(np.int64)
    vs, us = np.divmod(idx, W)
    rays = pixel_rays_at(K, T, us, vs)
    rgbs = np.ascontiguousarray(image.reshape(3, -1)[:, idx].T)
    return rays, labels[:, None].astype(np.float32), rgbs


def _append_id_columns(rays, cam_id, frame_id, spec):
    cols = [rays]
    n = rays.shape[0]
    if spec.pose_refinement:
        # packed pose-refinement layout [o, cam, d, cam]
        # (ref: ray_dataset.py:407-410)
        ids = np.full((n, 1), cam_id, np.float32)
        cols = [rays[:, :3], ids, rays[:, 3:6], ids]
        rays = np.concatenate(cols, 1)
        cols = [rays]
    if spec.use_deform_view:
        cols.append(np.full((n, 1), cam_id, np.float32))
    if spec.use_deform_time or spec.use_space_time:
        cols.append(np.full((n, 1), frame_id, np.float32))
    return np.concatenate(cols, 1) if len(cols) > 1 else rays


# DATASETS keys that do NOT change ray content: pure paths/labels excluded
# from the cache fingerprint so relocating data does not invalidate caches.
_FP_EXCLUDE = {"TRAIN", "TMP_RAYS", "TEST"}


def _cfg_fingerprint(cfg, spec=None) -> str:
    """Short stable hash of every config knob that affects generated rays.

    The cache filenames encode the headline knobs (frames/layers/rate/size);
    everything else that alters ray selection or content — CAMERA_STEPSIZE,
    FIXED_LAYER, SCALE, FIXED_NEAR/FAR, FILE_OFFSET, CAMERA_NUM, augmentation
    ranges, ... — folds into this fingerprint so a changed config can never
    silently serve a stale pool (round-2 advisor finding).

    ``spec`` adds the model flags that choose the packed f32 ray columns
    (pose_refinement / deform-view / time ids, _append_id_columns).
    """
    items = [(k, cfg.DATASETS[k]) for k in sorted(cfg.DATASETS)
             if k not in _FP_EXCLUDE]
    items.append(("SIZE_TRAIN", cfg.INPUT.SIZE_TRAIN))
    if spec is not None:
        items.append(("COLS", (spec.pose_refinement, spec.use_deform_view,
                               spec.use_deform_time or spec.use_space_time)))
    blob = repr([(k, repr(v)) for k, v in items]).encode()
    return hashlib.sha1(blob).hexdigest()[:10]


def _cache_path(cfg, frame_id: int, layer_id: int,
                compact: bool = False, spec=None) -> str:
    d = cfg.DATASETS
    fp = _cfg_fingerprint(cfg, spec if not compact else None)
    name = f"rays_px_{fp}.npz" if compact else f"rays_{fp}.npz"
    return os.path.join(d.TRAIN, d.TMP_RAYS, f"frame{frame_id}",
                        f"layer{layer_id}", name)


def transform_is_deterministic(transform) -> bool:
    """True when the joint transform applies no random augmentation — the
    precondition for the compact pixel pool (per-camera K tables)."""
    return not (getattr(transform, "random_range", 0)
                or getattr(transform, "random_ratio", 0)
                or getattr(transform, "random_rotation", 0))


def generate_frame_layer_rays(cfg, spec, transform, frame_id: int,
                              layer_id: int, use_label_map: bool,
                              sample_rate: float, rng: np.random.Generator,
                              compact: bool = False) -> dict:
    """Build (or load from cache) the ray set of one (frame, layer).

    ``compact`` stores {cams u16, pix u32, labels u8, rgb u8} — 10 bytes/ray
    instead of the 48-byte decoded f32 rows; rays/near-far are reconstructed
    from (cam, pix) + per-camera tables (build_ray_pool / make_decode).
    """
    d = cfg.DATASETS
    cache = _cache_path(cfg, frame_id, layer_id, compact, spec)
    cache_dir = os.path.dirname(cache)
    if compact:
        empty = {"cams": np.zeros((0,), np.uint16),
                 "pix": np.zeros((0,), np.uint32),
                 "labels": np.zeros((0,), np.uint8),
                 "rgb": np.zeros((0, 3), np.uint8)}
    else:
        empty = {"rays": np.zeros((0, 6), np.float32),
                 "rgbs": np.zeros((0, 3), np.float32),
                 "labels": np.zeros((0, 1), np.float32),
                 "near_fars": np.zeros((0, 2), np.float32)}
    if sample_rate == 0.0:
        return empty

    if os.path.exists(cache) and not cfg.clean_ray:
        with np.load(cache) as z:
            if set(z.files) == set(empty):
                return {k: z[k] for k in z.files}

    scene = FrameLayerScene(cfg, transform, frame_id, layer_id)
    parts = {k: [] for k in empty}
    for cam in range(0, scene.cam_num, d.CAMERA_STEPSIZE):
        image, label, K, T, _, bbox, near_far, ok = scene.get_data(cam)
        if not ok:
            continue
        if compact:
            pix, labels, rgbs = _select_pixels(image, label, K, T, layer_id,
                                               bbox, use_label_map,
                                               sample_rate, rng)
            parts["cams"].append(np.full(pix.shape[0], cam, np.uint16))
            parts["pix"].append(pix)
            parts["labels"].append(labels)
            parts["rgb"].append(rgbs)
        else:
            rays, labels, rgbs = _select_rays(image, label, K, T, layer_id,
                                              bbox, use_label_map,
                                              sample_rate, rng)
            rays = _append_id_columns(rays, cam, frame_id, spec)
            parts["rays"].append(rays)
            parts["rgbs"].append(rgbs)
            parts["labels"].append(labels.astype(np.float32))
            parts["near_fars"].append(np.repeat(near_far, rays.shape[0], axis=0))

    if not next(iter(parts.values())):
        return empty
    out = {k: np.concatenate(v) for k, v in parts.items()}
    os.makedirs(cache_dir, exist_ok=True)
    # uncompressed: zlib on float32 rays compresses poorly and costs minutes
    # per (frame, layer) at capture scale on a single host core
    np.savez(cache, **out)
    return out


def _layer_rate(d, layer_id: int) -> tuple[float, bool]:
    """(sample_rate, use_label_map) for a layer — background keeps
    BKGD_SAMPLE_RATE and always selects by segmentation; frozen layers
    contribute no rays (ref: ray_dataset.py:29-43)."""
    if layer_id == 0:
        return d.BKGD_SAMPLE_RATE, True
    rate = 0.0 if layer_id in list(d.FIXED_LAYER) else 1.0
    return rate, d.USE_LABEL


def _prefill_task(args):
    """One (frame, layer) pregeneration unit — module-level so it pickles
    into multiprocessing workers."""
    cfg, spec, frame_id, layer_id, use_label, rate, seed, compact = args
    from .transforms import JointTransform

    d = cfg.DATASETS
    rng = np.random.default_rng(seed)
    transform = JointTransform((cfg.INPUT.SIZE_TRAIN[1], cfg.INPUT.SIZE_TRAIN[0]),
                               d.SHIFT, d.MAXRATION, d.ROTATION, rng=rng)
    generate_frame_layer_rays(cfg, spec, transform, frame_id, layer_id,
                              use_label, rate, rng, compact=compact)
    return frame_id, layer_id


def prefill_ray_caches(cfg, spec, workers: int = 1, seed: int = 0,
                       compact: bool | None = None) -> int:
    """Populate the per-(frame, layer) ray caches in parallel.

    The reference pregenerates rays serially inside the first training epoch
    — hours of host work at capture scale (101 frames x ~70 cams at 1080p,
    ref: data/datasets/ray_dataset.py:374-451). Each (frame, layer) unit is
    independent, so they fan out over a process pool; every unit draws from
    its own seeded RNG, making the result independent of worker count.
    Returns the number of units actually generated (cache misses).
    """
    d = cfg.DATASETS
    if compact is None:
        compact = not (d.SHIFT or d.MAXRATION or d.ROTATION)
    frames = range(1 + d.FRAME_OFFSET, d.FRAME_OFFSET + d.FRAME_NUM + 1)
    tasks = []
    # frame-major: the serial path then reuses the decoded-image LRU cache
    # across a frame's layers (workers share nothing, so their order is
    # only a tie-break)
    for frame_id in frames:
        for layer_id in range(d.LAYER_NUM + 1):
            rate, use_label = _layer_rate(d, layer_id)
            if rate == 0.0:
                continue
            if os.path.exists(_cache_path(cfg, frame_id, layer_id, compact,
                                          spec)) \
                    and not cfg.clean_ray:
                continue
            tasks.append((cfg, spec, frame_id, layer_id, use_label, rate,
                          (seed, frame_id, layer_id), compact))
    if not tasks:
        return 0
    if workers > 1 and len(tasks) > 1:
        # spawn, not fork: the parent typically has live torch/CUDA threads
        # by the time pregeneration runs and forked children deadlock on
        # inherited locks. Workers never touch the card (pure NumPy).
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(min(workers, len(tasks))) as pool:
            pool.map(_prefill_task, tasks, chunksize=1)
    else:
        for t in tasks:
            _prefill_task(t)
    return len(tasks)


def _transformed_K(K: np.ndarray, orig_hw, out_hw) -> np.ndarray:
    """Deterministic crop+resize K update — the zero-augmentation slice of
    JointTransform's intrinsics math (data/transforms.py)."""
    K = np.array(K, np.float32, copy=True)
    K *= out_hw[0] / orig_hw[0]
    K[2, 2] = 1.0
    return K


def build_ray_pool(cfg, spec, rng: np.random.Generator | None = None,
                   transform=None, workers: int = 1,
                   compact: bool | None = None) -> tuple[dict, np.ndarray]:
    """Pregenerate the full training pool over all layers x frames.

    Returns (pool dict of flat arrays, bboxes (F+offset, L, 2, 3)) —
    the per-frame performer bboxes feed SceneBoxes.
    (ref: Ray_Dataset.__init__, ray_dataset.py:15-65)

    ``compact`` (default: auto — on when the transform is deterministic)
    returns the compact pixel bundle: per-ray {cams u16, pix u32, frames
    u16, labels u8, bbox_labels u8, rgb u8} (13 bytes/ray vs 56 decoded)
    plus per-camera tables {table_inv_K, table_rot, table_origin,
    table_near_far} and "width"; rays are reconstructed on device
    (engine/trainer.make_decode) or on host (:func:`decode_pool_host`).
    Randomly-augmented transforms fall back to the decoded f32 format
    (per-sample warped K cannot live in per-camera tables).

    ``workers > 1`` fans the per-(frame, layer) pregeneration out over a
    process pool before the (cache-served) assembly loop.
    """
    from .transforms import JointTransform

    d = cfg.DATASETS
    rng = rng or np.random.default_rng(0)
    if transform is None:
        transform = JointTransform((cfg.INPUT.SIZE_TRAIN[1], cfg.INPUT.SIZE_TRAIN[0]),
                                   d.SHIFT, d.MAXRATION, d.ROTATION, rng=rng)
    if compact is None:
        compact = transform_is_deterministic(transform)

    # assembled-pool cache: one consolidated file so a retried run skips the
    # per-(frame, layer) load+concat pass (an hour of host copies at capture
    # scale on this class of host)
    cap = getattr(d, "MAX_POOL_RAYS", 0)
    hit_order = bool(compact and d.LAYER_NUM
                     and getattr(cfg.TPU, "POOL_HIT_ORDER", False))
    fmt = ("px_ho" if hit_order else "px") if compact else "f32"
    # the fingerprint covers every remaining DATASETS/INPUT (and, for the
    # f32 format, ray-column) knob so a config change can never silently
    # serve a stale assembled pool or stale camera tables
    fp = _cfg_fingerprint(cfg, spec if not compact else None)
    bundle_file = os.path.join(
        d.TRAIN, d.TMP_RAYS,
        f"pool_F{d.FRAME_NUM}_O{d.FRAME_OFFSET}_L{d.LAYER_NUM}"
        f"_r{d.BKGD_SAMPLE_RATE:g}_u{int(d.USE_LABEL)}"
        f"_w{cfg.INPUT.SIZE_TRAIN[0]}x{cfg.INPUT.SIZE_TRAIN[1]}"
        f"_cap{cap}_{fmt}_{fp}.npz")
    boxes_file = bundle_file.replace(".npz", "_boxes.npy")
    if (os.path.exists(bundle_file) and os.path.exists(boxes_file)
            and not cfg.clean_ray):
        logger.info("loading consolidated pool bundle %s", bundle_file)
        with np.load(bundle_file) as z:
            return {k: z[k] for k in z.files}, np.load(boxes_file)
    logger.info("assembling pool bundle -> %s", bundle_file)

    if workers > 1:
        # workers rebuild the transform from cfg (_prefill_task); a custom
        # transform with different geometry would populate the caches the
        # serial assembly pass below then reads with DIFFERENT pixels —
        # refuse the fan-out rather than mix transforms (round-2 advisor)
        ref = JointTransform((cfg.INPUT.SIZE_TRAIN[1], cfg.INPUT.SIZE_TRAIN[0]),
                             d.SHIFT, d.MAXRATION, d.ROTATION)
        same = all(getattr(transform, a, None) == getattr(ref, a)
                   for a in ("size", "random_range", "random_ratio",
                             "random_rotation"))
        if same:
            prefill_ray_caches(cfg, spec, workers=workers, compact=compact)
        else:
            logger.warning("build_ray_pool: custom transform differs from the "
                           "cfg-derived one; pregenerating serially so every "
                           "cache uses the caller's transform")

    frames = range(1 + d.FRAME_OFFSET, d.FRAME_OFFSET + d.FRAME_NUM + 1)
    boxes = np.zeros((d.FRAME_NUM + d.FRAME_OFFSET, d.LAYER_NUM, 2, 3), np.float32)
    parts = []
    nf_table = None
    # frame-major so all layers of a frame reuse the decoded-image LRU
    # cache (scene._decoded_image); pool order is irrelevant downstream —
    # the trainer draws random batches
    for frame_id in frames:
        for layer_id in range(d.LAYER_NUM + 1):
            rate, use_label = _layer_rate(d, layer_id)
            part = generate_frame_layer_rays(cfg, spec, transform, frame_id,
                                             layer_id, use_label, rate, rng,
                                             compact=compact)
            scene = FrameLayerScene(cfg, transform, frame_id, layer_id)
            if layer_id != 0 and scene.bbox is not None:
                boxes[frame_id - 1, layer_id - 1] = scene.bbox
            part = dict(part)
            n_part = part["pix" if compact else "rays"].shape[0]
            # every ray of this set nominally belongs to this layer
            # (ref: ray_dataset.py:454); the true pixel segmentation stays in
            # "labels" and drives the mask-alpha loss
            if compact:
                part["bbox_labels"] = np.full(n_part, layer_id, np.uint8)
                part["frames"] = np.full(n_part, frame_id, np.uint16)
                if nf_table is None:
                    nf_table = np.zeros(
                        (d.LAYER_NUM + 1, d.FRAME_OFFSET + d.FRAME_NUM + 1,
                         scene.cam_num, 2), np.float32)
                off = scene.file_offset if scene.use_camera_num else 0
                sl = slice(off, off + scene.cam_num)
                nf_table[layer_id, frame_id, :, 0] = scene.near[sl]
                nf_table[layer_id, frame_id, :, 1] = scene.far[sl]
            else:
                part["bbox_labels"] = np.full_like(part["labels"], layer_id)
            parts.append(part)

    pool = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    n = pool[next(iter(pool))].shape[0]
    if cap and n > cap:
        keep = rng.choice(n, size=cap, replace=False)
        keep.sort()
        pool = {k: v[keep] for k, v in pool.items()}

    if compact:
        # per-camera constant tables for on-device ray decoding
        scene = FrameLayerScene(cfg, transform, 1 + d.FRAME_OFFSET, 0)
        out_w, out_h = cfg.INPUT.SIZE_TRAIN
        orig_w, orig_h = scene.original_size()
        off = scene.file_offset if scene.use_camera_num else 0
        cams = [c + off for c in range(scene.cam_num)]
        Ks = [_transformed_K(scene.Ks[c], (orig_h, orig_w), (out_h, out_w))
              for c in cams]
        pool["table_inv_K"] = np.stack(
            [np.linalg.inv(K).astype(np.float32) for K in Ks])
        pool["table_rot"] = np.stack(
            [scene.Ts[c, :3, :3].astype(np.float32) for c in cams])
        pool["table_origin"] = np.stack(
            [scene.Ts[c, :3, 3].astype(np.float32) for c in cams])
        pool["table_near_far"] = nf_table if nf_table is not None else \
            np.zeros((d.LAYER_NUM + 1, 1, scene.cam_num, 2), np.float32)
        pool["width"] = np.int64(out_w)

    if hit_order:
        logger.info("ordering pool by (frame, bbox-hit pattern), "
                    "shuffled within groups (%d rays)",
                    pool["pix"].shape[0])
        pool = order_pool_by_hit(pool, boxes, rng)

    os.makedirs(os.path.dirname(bundle_file), exist_ok=True)
    np.savez(bundle_file, **pool)
    np.save(boxes_file, boxes)
    return pool, boxes


def pool_hit_keys(pool: dict, boxes: np.ndarray,
                  chunk: int = 1 << 20) -> np.ndarray:
    """Per-ray (frame << L) | bbox-hit-pattern sort keys for a compact pool.

    Host mirror of the trainer's on-device hit test (slab intersection as
    ops.sampling.ray_aabb_intersect, identity pose refinement/edits): the
    keys only steer pool ORDER, never outputs — the kernels recompute their
    tile-skip flags from the true geometry per batch."""
    n = int(pool["pix"].shape[0])
    L = int(boxes.shape[1])
    inv_K = np.asarray(pool["table_inv_K"], np.float32)
    rot = np.asarray(pool["table_rot"], np.float32)
    origin = np.asarray(pool["table_origin"], np.float32)
    width = int(pool["width"])
    key = np.empty(n, np.int64)
    eps = np.float32(np.finfo(np.float64).eps)   # ops.sampling slab eps
    for a in range(0, n, chunk):
        b = min(a + chunk, n)
        cam = pool["cams"][a:b].astype(np.int64)
        pix = pool["pix"][a:b].astype(np.int64)
        fr = pool["frames"][a:b].astype(np.int64)
        vs, us = np.divmod(pix, width)
        p3 = np.stack([us, vs, np.ones_like(us)], -1).astype(np.float32)
        d = np.einsum("nij,nj->ni", inv_K[cam], p3)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        d = np.einsum("nij,nj->ni", rot[cam], d)
        o = origin[cam]
        fb = boxes[np.clip(fr - 1, 0, boxes.shape[0] - 1)]    # (B, L, 2, 3)
        inv_d = 1.0 / (d + eps)
        t1 = (fb[..., 0, :] - o[:, None]) * inv_d[:, None]    # (B, L, 3)
        t2 = (fb[..., 1, :] - o[:, None]) * inv_d[:, None]
        t_near = np.minimum(t1, t2).max(-1)
        t_far = np.maximum(t1, t2).min(-1)
        hit = t_far > t_near                                  # (B, L)
        pattern = (hit.astype(np.int64)
                   << np.arange(L, dtype=np.int64)[None]).sum(-1)
        key[a:b] = (fr << L) | pattern
    return key


def order_pool_by_hit(pool: dict, boxes: np.ndarray,
                      rng: np.random.Generator,
                      chunk: int = 1 << 20) -> dict:
    """Globally order a COMPACT pool by (frame, performer-bbox hit pattern),
    shuffled within each group.

    Performance-only: the kernels' per-tile skip flags are recomputed on
    device per batch from the true geometry, so ordering cannot change any
    output — it makes the trainer's locality-preserving block draws
    (engine/trainer ``POOL_BLOCK_DRAW``) hit-homogeneous at kernel-tile
    granularity, which is what lets a performer field's MXU work be skipped
    for miss-only tiles (the pool-level analogue of
    engine/trainer.sort_batch_by_hit, which can only reorder WITHIN a batch
    whose draw already mixed patterns). The within-group shuffle matters:
    assembly order is image-scan order, and a block of adjacent pixels of
    one image would be a correlated gradient sample.

    ``boxes``: (F[, +offset], L, 2, 3) per-frame performer boxes (1-based
    frame ids index ``boxes[frame-1]``, as models.layered._gather_boxes).
    """
    n = int(pool["pix"].shape[0])
    if n == 0 or int(boxes.shape[1]) == 0:
        return pool
    order = np.lexsort((rng.random(n), pool_hit_keys(pool, boxes, chunk)))
    # permute the per-ray columns BY NAME — a shape heuristic would silently
    # permute any table whose leading dim happens to equal the ray count
    per_ray = {"cams", "pix", "frames", "labels", "bbox_labels", "rgb"}
    out = {k: (np.asarray(v)[order] if k in per_ray else v)
           for k, v in pool.items()}
    out["hit_ordered"] = np.int64(1)
    return out


def decode_pool_host(bundle: dict, spec) -> dict:
    """Compact pixel bundle -> decoded f32 pool dict {rays, rgbs, labels,
    near_fars, bbox_labels} (the legacy layout), on host. Mirrors the
    device decoder (engine/trainer.make_decode) for consumers that want
    packed rays."""
    W = int(bundle["width"])
    cams = bundle["cams"].astype(np.int64)
    pix = bundle["pix"].astype(np.int64)
    vs, us = np.divmod(pix, W)

    K_inv = bundle["table_inv_K"][cams]                       # (N, 3, 3)
    p3 = np.stack([us, vs, np.ones_like(us)], -1).astype(np.float32)
    d = np.einsum("nij,nj->ni", K_inv, p3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = np.einsum("nij,nj->ni", bundle["table_rot"][cams], d)
    o = bundle["table_origin"][cams]

    frames = bundle["frames"].astype(np.int64)
    bl = bundle["bbox_labels"].astype(np.int64)
    nf = bundle["table_near_far"][bl, frames, cams]           # (N, 2)

    rays = np.concatenate([o, d], axis=1).astype(np.float32)
    # id columns follow _append_id_columns (the reference ray layouts)
    if spec.pose_refinement:
        ids = cams[:, None].astype(np.float32)
        rays = np.concatenate([rays[:, :3], ids, rays[:, 3:6], ids], 1)
    cols = [rays]
    if spec.use_deform_view:
        cols.append(cams[:, None].astype(np.float32))
    if spec.use_deform_time or spec.use_space_time:
        cols.append(frames[:, None].astype(np.float32))
    return {"rays": np.concatenate(cols, 1) if len(cols) > 1 else rays,
            "rgbs": bundle["rgb"].astype(np.float32) / 255.0,
            "labels": bundle["labels"][:, None].astype(np.float32),
            "near_fars": nf.astype(np.float32),
            "bbox_labels": bundle["bbox_labels"][:, None].astype(np.float32)}
