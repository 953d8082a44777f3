"""Synthetic layered-scene generator — the port's copy of
``stnerf_tpu/data/synthetic.py``: the same tree and the same pixels from the
same seed, with images written by the port's PNG codec (``data/png.py``).

Writes a complete dataset in the reference's on-disk layout
(ref: data/datasets/frame_dataset.py:109-129: ``pose/RT_c2w.txt``,
``pose/K.txt``, ``frame{F}/images/%03d.png``, ``frame{F}/labels/%03d.npy``,
``frame{F}/pointclouds/{L}.ply``, ``background/0.ply``) so the full
pipeline — ray pregeneration, training, rendering, demos — runs end-to-end
without the (unshipped) capture data. The scene is analytic: a large
background sphere enclosing everything plus ``layer_num`` moving performer
bodies; images are ray-cast in NumPy with per-pixel layer labels.

Two capture-statistics regimes beyond the default tight single-sphere
performers (ref: data/datasets/frame_dataset.py:149-206 — real captures
have articulated humans whose per-frame point-cloud hulls are loose and
whose segmentation labels are imperfect):

* ``blobs`` > 1: each performer is an articulated body of ``blobs``
  spheres (a torso plus limbs) that spread apart over the sequence by
  ``blob_spread`` world units — the PLY-derived hull box then encloses
  real interior gaps, the regime ``TPU.OCC_SLICES`` / ``OCC_GAP_SKIP``
  target (a single-sphere performer has none).
* ``label_noise`` > 0: segmentation labels get boundary-biased errors
  (each label-boundary pixel swaps to a random neighbor's label with that
  probability) plus a ``label_noise/10`` salt of uniformly random labels —
  mimicking imperfect human matting; the images stay exact.
"""

from __future__ import annotations

import os

import numpy as np

from .cameras import lookat, pixel_rays
from .ply import write_ply_points
from .png import write_png

BG_RADIUS = 8.0
SPHERE_RADIUS = 0.8
LIMB_RADIUS_FRAC = 0.55     # limb blob radius as a fraction of the torso's


def performer_center(layer: int, frame: int, num_frames: int) -> np.ndarray:
    """Deterministic motion path of performer ``layer`` (1-based) at
    ``frame`` (1-based)."""
    u = (frame - 1) / max(num_frames - 1, 1)
    if layer % 2 == 1:
        return np.array([-1.2 + 2.4 * u, 0.0, 0.3 * np.sin(2 * np.pi * u)],
                        np.float32) + np.array([0, 0, (layer - 1) * 0.5], np.float32)
    return np.array([0.3 * np.sin(2 * np.pi * u), 1.4 - 0.8 * u, 0.0],
                    np.float32) + np.array([0, 0, (layer - 2) * 0.5], np.float32)


def blob_geometry(layer: int, frame: int, num_frames: int, blobs: int,
                  spread: float, axis: int = -1):
    """Centers (B, 3) and radii (B,) of performer ``layer``'s body blobs.

    Blob 0 is the torso at :func:`performer_center`; blobs 1.. are limbs
    offset along fixed per-(layer, blob) unit directions whose magnitude
    grows with the frame fraction (``0.35 + 0.65 u``) times ``spread`` —
    the body articulates apart over the sequence, so later frames' hulls
    have the largest interior gaps.

    ``axis`` >= 0 makes the articulation AXIS-DOMINANT: limb j alternates
    +/- along that world axis with only 15%-of-spread transverse jitter —
    a row of blobs with single-axis-separable gaps, the structure real
    humans have (legs/arms spread along one body axis) and the one
    ``TPU.OCC_SLICES`` can carve (K sub-boxes along ONE dominant axis
    cannot separate blobs articulated in general 3D position)."""
    c = performer_center(layer, frame, num_frames)
    if blobs <= 1:
        return c[None], np.array([SPHERE_RADIUS], np.float32)
    u = (frame - 1) / max(num_frames - 1, 1)
    rng = np.random.default_rng(10_007 * layer)      # per-layer fixed limbs
    if axis >= 0:
        dirs = 0.15 * rng.normal(size=(blobs - 1, 3)).astype(np.float64)
        sign = np.where(np.arange(blobs - 1) % 2 == 0, 1.0, -1.0)
        dirs[:, axis % 3] = sign * (1.0 + 0.25 * rng.random(blobs - 1))
    else:
        dirs = rng.normal(size=(blobs - 1, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    mag = spread * (0.35 + 0.65 * u)
    centers = np.concatenate([c[None], c[None] + mag * dirs]).astype(np.float32)
    radii = np.full(blobs, SPHERE_RADIUS * LIMB_RADIUS_FRAC, np.float32)
    radii[0] = SPHERE_RADIUS
    return centers, radii


def _bg_color(p: np.ndarray) -> np.ndarray:
    return 0.5 + 0.45 * np.stack([np.sin(0.6 * p[..., 0]),
                                  np.sin(0.6 * p[..., 1] + 2.0),
                                  np.cos(0.6 * p[..., 2])], -1)


def _performer_color(layer: int, p: np.ndarray, center: np.ndarray) -> np.ndarray:
    base = np.array([[0.85, 0.25, 0.2], [0.2, 0.4, 0.85], [0.2, 0.8, 0.3],
                     [0.8, 0.7, 0.2]][(layer - 1) % 4], np.float32)
    local = (p - center) / SPHERE_RADIUS
    return np.clip(base + 0.15 * local, 0.0, 1.0)


def _intersect_sphere(o, d, center, radius):
    """Smallest positive t of |o + t d - c| = r, inf when missed."""
    oc = o - center
    b = np.sum(oc * d, -1)
    c = np.sum(oc * oc, -1) - radius**2
    disc = b * b - c
    ok = disc >= 0
    sq = np.sqrt(np.maximum(disc, 0))
    t1, t2 = -b - sq, -b + sq
    t = np.where(t1 > 1e-3, t1, t2)
    return np.where(ok & (t > 1e-3), t, np.inf)


def raycast(o: np.ndarray, d: np.ndarray, frame: int, num_frames: int,
            layer_num: int, blobs: int = 1, blob_spread: float = 0.0,
            blob_axis: int = -1):
    """-> (rgb (N,3), label (N,), depth (N,)) analytic ground truth."""
    n = o.shape[0]
    best_t = _intersect_sphere(o, d, np.zeros(3, np.float32), BG_RADIUS)
    label = np.zeros(n, np.int64)
    centers = {}
    for l in range(1, layer_num + 1):
        cs, rs = blob_geometry(l, frame, num_frames, blobs, blob_spread,
                               blob_axis)
        centers[l] = cs
        for c, r in zip(cs, rs):
            t = _intersect_sphere(o, d, c, r)
            hit = t < best_t
            best_t = np.where(hit, t, best_t)
            label = np.where(hit, l, label)
    p = o + best_t[:, None] * d
    rgb = _bg_color(p)
    for l in range(1, layer_num + 1):
        # color is shaded from the torso center — one body, many blobs
        rgb = np.where((label == l)[:, None],
                       _performer_color(l, p, centers[l][0]), rgb)
    return rgb.astype(np.float32), label, best_t.astype(np.float32)


def _camera_ring(num_cams: int, radius: float = 5.0, height: float = 0.6):
    poses = []
    for i in range(num_cams):
        ang = np.pi * (0.15 + 0.7 * i / max(num_cams - 1, 1))
        eye = np.array([radius * np.cos(ang), height, radius * np.sin(ang)])
        poses.append(lookat(eye, np.zeros(3), np.array([0.0, 1.0, 0.0])))
    return np.stack(poses)


def _sphere_points(center, radius, n, rng):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return (center + radius * v).astype(np.float32)


def _noisify_label(label: np.ndarray, p: float,
                   rng: np.random.Generator, layer_num: int) -> np.ndarray:
    """Boundary-biased label corruption: every pixel whose 4-neighborhood
    crosses a label boundary swaps to a random neighbor's label with
    probability ``p``, and a ``p/10`` fraction of ALL pixels becomes a
    uniformly random label (salt). Matches how real matting fails — mostly
    at silhouettes, occasionally anywhere."""
    if p <= 0:
        return label
    out = label.copy()
    shifts = [np.roll(label, 1, 0), np.roll(label, -1, 0),
              np.roll(label, 1, 1), np.roll(label, -1, 1)]
    boundary = np.zeros(label.shape, bool)
    for s in shifts:
        boundary |= s != label
    pick = np.stack(shifts, 0)[rng.integers(0, 4, label.shape),
                               np.arange(label.shape[0])[:, None],
                               np.arange(label.shape[1])[None]]
    flip = boundary & (rng.random(label.shape) < p)
    out[flip] = pick[flip]
    salt = rng.random(label.shape) < (p / 10.0)
    out[salt] = rng.integers(0, layer_num + 1, label.shape)[salt]
    return out


def make_synthetic_scene(root: str, width: int = 200, height: int = 150,
                         num_cams: int = 12, num_frames: int = 5,
                         layer_num: int = 2, seed: int = 0,
                         bbox_slack: float = 0.0, blobs: int = 1,
                         blob_spread: float = 0.0, blob_axis: int = -1,
                         label_noise: float = 0.0) -> None:
    """Write the full dataset tree under ``root``.

    ``bbox_slack`` > 0 appends invisible outlier corner points at
    center +- radius*(1+slack) to each performer point cloud, inflating the
    derived hull bbox without changing the rendered images — mimicking real
    capture scenes whose per-frame point-cloud hulls are loose around
    articulated humans (the regime TPU.OCCUPANCY_SKIP targets; the default
    tight boxes make empty-space skipping a geometric no-op).

    ``blobs`` / ``blob_spread`` / ``label_noise``: capture-statistics
    regimes — articulated multi-blob performers whose hulls carry interior
    gaps, and imperfect segmentation labels (module docstring)."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "pose"), exist_ok=True)
    os.makedirs(os.path.join(root, "background"), exist_ok=True)

    poses = _camera_ring(num_cams)
    f = 0.9 * width
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], np.float32)

    np.savetxt(os.path.join(root, "pose", "RT_c2w.txt"),
               poses[:, :3, :].reshape(num_cams, 12), fmt="%.8g")
    np.savetxt(os.path.join(root, "pose", "K.txt"),
               np.tile(K.reshape(1, 9), (num_cams, 1)), fmt="%.8g")

    write_ply_points(os.path.join(root, "background", "0.ply"),
                     _sphere_points(np.zeros(3), BG_RADIUS, 4000, rng))

    for frame in range(1, num_frames + 1):
        fdir = os.path.join(root, f"frame{frame}")
        # resumable at capture scale: a frame whose last-written artifact
        # (the final camera's label) exists is complete — skip it, so an
        # interrupted 1080p generation picks up where it stopped. The RNG
        # is re-seeded per frame so skipped frames do not shift the stream.
        rng = np.random.default_rng(seed + 7919 * frame)
        if os.path.exists(os.path.join(fdir, "labels",
                                       f"{num_cams - 1:03d}.npy")):
            continue
        os.makedirs(os.path.join(fdir, "images"), exist_ok=True)
        os.makedirs(os.path.join(fdir, "labels"), exist_ok=True)
        os.makedirs(os.path.join(fdir, "pointclouds"), exist_ok=True)
        for l in range(1, layer_num + 1):
            centers, radii = blob_geometry(l, frame, num_frames, blobs,
                                           blob_spread, blob_axis)
            area = radii**2
            counts = np.maximum((1500 * area / area.sum()).astype(int), 64)
            pts = np.concatenate([
                _sphere_points(c, r, int(n), rng)
                for c, r, n in zip(centers, radii, counts)])
            if bbox_slack > 0:
                r = SPHERE_RADIUS * (1.0 + bbox_slack)
                corners = centers[0] + r * np.array(
                    [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                     for sz in (-1, 1)], np.float32)
                pts = np.concatenate([pts, corners.astype(np.float32)])
            write_ply_points(os.path.join(fdir, "pointclouds", f"{l}.ply"),
                             pts)
        for cam in range(num_cams):
            rays = pixel_rays(K, poses[cam], height, width)
            rgb, label, _ = raycast(rays[:, :3], rays[:, 3:6], frame,
                                    num_frames, layer_num, blobs, blob_spread,
                                    blob_axis)
            img = (rgb.reshape(height, width, 3) * 255).astype(np.uint8)
            write_png(os.path.join(fdir, "images", f"{cam:03d}.png"), img)
            lab = label.reshape(height, width).astype(np.uint8)
            lab = _noisify_label(lab, label_noise, rng, layer_num)
            # atomic: labels double as the frame-complete sentinel above —
            # a kill mid-write must not leave a truncated file the resumed
            # generation would treat as done
            lab_path = os.path.join(fdir, "labels", f"{cam:03d}.npy")
            np.save(lab_path + ".tmp.npy", lab)
            os.replace(lab_path + ".tmp.npy", lab_path)


def synthetic_cfg(root: str, width: int = 200, height: int = 150,
                  num_frames: int = 5, layer_num: int = 2):
    """A config wired for the synthetic scene (BBOX sampling, space-time +
    deformation on, as the taekwondo config uses)."""
    from ..config import get_cfg

    cfg = get_cfg()
    cfg.DATASETS.TRAIN = root
    cfg.DATASETS.FRAME_NUM = num_frames
    cfg.DATASETS.LAYER_NUM = layer_num
    cfg.DATASETS.USE_LABEL = True
    cfg.DATASETS.BKGD_SAMPLE_RATE = 0.05
    cfg.INPUT.SIZE_TRAIN = [width, height]
    cfg.INPUT.SIZE_TEST = [width, height]
    cfg.INPUT.SIZE_LAYER = [width, height]
    cfg.MODEL.SAMPLE_METHOD = "BBOX"
    cfg.MODEL.POSE_REFINEMENT = False
    cfg.MODEL.USE_DEFORM_TIME = True
    cfg.MODEL.USE_SPACE_TIME = True
    cfg.MODEL.DEEP_RGB = False
    cfg.MODEL.REMOVE_OUTLIERS = True
    cfg.SOLVER.OPTIMIZER_NAME = "Adam"
    cfg.SOLVER.BASE_LR = 4e-4
    cfg.SOLVER.IMS_PER_BATCH = 2000
    cfg.SOLVER.BUNCH = 2000
    cfg.SOLVER.COARSE_STAGE = 1
    return cfg
