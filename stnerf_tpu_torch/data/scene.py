"""Per-(frame, layer) scene ingestion — the port's copy of
``stnerf_tpu/data/scene.py``, with images read by the port's PNG codec
(``data/png.py``) instead of PIL.

Host-side counterpart of the reference's ``FrameLayerDataset``
(ref: data/datasets/frame_dataset.py:94-303): loads shared camera tables
(``pose/RT_c2w.txt``, ``pose/K.txt``), the per-frame-layer point cloud
(``frame{F}/pointclouds/{L}.ply``; background ``background/0.ply``), computes
and disk-caches the AABB bbox + center (``bbox_tmp/...``) and the per-camera
near/far from the point cloud's camera-space z-range (``near_far_tmp/...``),
and serves transformed images/labels. Caches are ``.npy`` (torch-free) in the
same directory layout so a dataset can be shared with the reference tooling.
"""

from __future__ import annotations

import functools as _functools
import os

import numpy as np

from .cameras import load_camposes, load_intrinsics, load_view_mask
from .ply import read_ply_points
from .png import png_size, read_png
from .transforms import JointTransform


@_functools.lru_cache(maxsize=24)
def _decoded_image(path: str) -> np.ndarray:
    """Decoded uint8 HxWx(3|4) image, LRU-cached by path.

    Pool pregeneration visits every frame's images once per layer
    (build_ray_pool iterates frame-major); caching the decode serves layers
    2..L for free — at 1080p the PNG decode is the single largest remaining
    pregeneration cost on a 1-core host. 24 entries ≈ one frame's cameras
    (~150 MB at 1080p uint8)."""
    return read_png(path)


BBOX_CORNER_ORDER = np.array([
    # corner indexing the reference uses: 0..3 bottom (z=min), 4..7 top
    # (ref: data/datasets/frame_dataset.py:62-63, 187-188)
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.int64)


def corners_from_minmax(bmin: np.ndarray, bmax: np.ndarray) -> np.ndarray:
    """(2,3) min/max -> (8,3) corner array in the reference's corner order."""
    lohi = np.stack([bmin, bmax])  # (2, 3)
    return np.stack([lohi[BBOX_CORNER_ORDER[i], [0, 1, 2]] for i in range(8)])


def minmax_from_corners(corners: np.ndarray) -> np.ndarray:
    c = np.asarray(corners).reshape(-1, 3)
    return np.stack([c.min(0), c.max(0)])


class FrameLayerScene:
    """Geometry + imagery for one (frame, layer)."""

    def __init__(self, cfg, transform: JointTransform | None, frame_id: int,
                 layer_id: int):
        d = cfg.DATASETS
        root = d.TRAIN
        self.root = root
        self.frame_id = frame_id
        self.layer_id = layer_id
        self.transform = transform
        self.file_offset = d.FILE_OFFSET
        self.use_camera_num = d.CAMERA_NUM

        self.image_dir = os.path.join(root, f"frame{frame_id}", "images")
        self.label_dir = os.path.join(root, f"frame{frame_id}", "labels")
        if layer_id == 0:
            pc_dirs = [os.path.join(root, "background")]
        else:
            pc_dirs = [os.path.join(root, f"frame{frame_id}", "pointclouds"),
                       os.path.join(root, "background")]

        scale = d.SCALE
        self.Ts = load_camposes(os.path.join(root, "pose", "RT_c2w.txt"))
        self.Ts[:, :3, 3] *= scale
        self.Ks = load_intrinsics(os.path.join(root, "pose", "K.txt"))
        self.cam_num = d.CAMERA_NUM or self.Ts.shape[0]

        self.view_mask = np.ones(self.Ts.shape[0], np.int64)
        if d.VIEW_MASK and os.path.exists(d.VIEW_MASK):
            self.view_mask = load_view_mask(d.VIEW_MASK)

        pc_path = None
        for base in pc_dirs:
            cand = os.path.join(base, f"{layer_id}.ply")
            if os.path.exists(cand):
                pc_path = cand
                break

        self._pointcloud = None
        self._pc_path, self._pc_scale = pc_path, scale
        self.bbox, self.center = self._load_bbox(pc_path, scale)
        self.near, self.far = self._load_near_far(cfg, pc_path)

    # -- cached geometry ---------------------------------------------------
    def _cache_dir(self, kind: str) -> str:
        return os.path.join(self.root, kind, f"frame{self.frame_id}",
                            f"layer{self.layer_id}")

    def _points(self) -> np.ndarray:
        if self._pointcloud is None:
            self._pointcloud = read_ply_points(self._pc_path) * self._pc_scale
        return self._pointcloud

    def _load_bbox(self, pc_path, scale):
        cache = self._cache_dir("bbox_tmp")
        b_f, c_f = os.path.join(cache, "bbox.npy"), os.path.join(cache, "center.npy")
        if os.path.exists(b_f):
            bbox = np.load(b_f)
            return (bbox if bbox.shape == (2, 3) else minmax_from_corners(bbox),
                    np.load(c_f))
        if pc_path is None:
            return None, np.zeros(3, np.float32)
        pts = self._points()
        bbox = np.stack([pts.min(0), pts.max(0)])
        center = bbox.mean(0)
        os.makedirs(cache, exist_ok=True)
        np.save(b_f, bbox)
        np.save(c_f, center)
        return bbox, center

    def _load_near_far(self, cfg, pc_path):
        d = cfg.DATASETS
        m = self.Ts.shape[0]
        if not (d.FIXED_NEAR == -1.0 and d.FIXED_FAR == -1.0):
            return (np.full(m, d.FIXED_NEAR, np.float32),
                    np.full(m, d.FIXED_FAR, np.float32))
        cache = self._cache_dir("near_far_tmp")
        n_f, f_f = os.path.join(cache, "near.npy"), os.path.join(cache, "far.npy")
        if os.path.exists(n_f):
            return np.load(n_f), np.load(f_f)
        if pc_path is None:
            return np.zeros(m, np.float32), np.full(m, 10.0, np.float32)
        pts = self._points()
        w2c = np.linalg.inv(self.Ts)  # (M, 4, 4)
        z = pts @ w2c[:, 2, :3].transpose(1, 0) + w2c[:, None, 2, 3].reshape(1, m)
        near = z.min(0).astype(np.float32)
        far = z.max(0).astype(np.float32)
        os.makedirs(cache, exist_ok=True)
        np.save(n_f, near)
        np.save(f_f, far)
        return near, far

    # -- imagery -----------------------------------------------------------
    def _find(self, directory: str, cam: int, exts) -> str | None:
        for pat in (f"{cam:03d}", f"{cam}"):
            for ext in exts:
                p = os.path.join(directory, pat + ext)
                if os.path.exists(p):
                    return p
        return None

    def get_data(self, camera_id: int):
        """-> (image (3,H,W), label (1,H,W), K, T, roi, bbox(2,3),
        near_far (1,2), mask_flag). Mirrors FrameLayerDataset.get_data
        (ref: frame_dataset.py:252-291) including the synthesized full-layer
        label when no label map exists (ref: :278-284)."""
        if self.use_camera_num != 0:
            camera_id = camera_id + self.file_offset
        if self.view_mask[camera_id] == 0:
            return None, None, None, None, None, None, None, 0

        T, K = self.Ts[camera_id], self.Ks[camera_id]
        img_path = self._find(self.image_dir, camera_id, (".png", ".jpg"))
        img = _decoded_image(img_path) if img_path else None

        lab_path = self._find(self.label_dir, camera_id, (".npy",)) or \
            self._find(self.label_dir, camera_id, ("_label.npy",))
        if lab_path:
            label = np.load(lab_path)
        elif img is not None:
            label = np.full(img.shape[:2], self.layer_id, np.uint8)
        else:
            label = None

        image, label, K, T, roi = self.transform(img, K, T, label=label)
        near_far = np.array([[self.near[camera_id], self.far[camera_id]]], np.float32)
        return image, label, K, T, roi, self.bbox, near_far, int(self.view_mask[camera_id])

    def original_size(self):
        p = self._find(self.image_dir, 0, (".png", ".jpg"))
        return png_size(p)  # (W, H)
