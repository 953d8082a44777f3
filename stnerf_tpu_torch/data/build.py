"""Dataset facade: render-time and validation scene access + train pool —
the port's copy of ``stnerf_tpu/data/build.py``.

Counterpart of the reference's loader factories and render/view datasets
(ref: data/build.py:13-57, data/datasets/ray_dataset.py:85-337), minus the
torch DataLoader machinery — batches are sliced from flat NumPy pools. The
scene boxes are torch tensors on the device the caller names (the CUDA card
unless another is named).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device
from ..models import RayInputs, SceneBoxes
from .cameras import pixel_rays
from .raygen import build_ray_pool
from .scene import FrameLayerScene
from .transforms import JointTransform


def _test_transform(cfg):
    return JointTransform((cfg.INPUT.SIZE_TEST[1], cfg.INPUT.SIZE_TEST[0]),
                          is_train=False)


def _scene_boxes(bkgd: FrameLayerScene, boxes: np.ndarray, device) -> SceneBoxes:
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return SceneBoxes(bkgd_box=t(bkgd.bbox), boxes=t(boxes),
                      bkgd_near_far=t([float(bkgd.near.min()), float(bkgd.far.max())]))


class RenderScene:
    """Geometry + camera tables for free-viewpoint rendering
    (ref: Ray_Dataset_Render, data/datasets/ray_dataset.py:203-337)."""

    def __init__(self, cfg, device=None):
        device = resolve_device(device)
        self.cfg = cfg
        d = cfg.DATASETS
        self.layer_num = d.LAYER_NUM
        self.frame_num = d.FRAME_NUM
        self.frame_offset = d.FRAME_OFFSET
        transform = _test_transform(cfg)

        self.layers = []  # [layer][frame_idx] -> FrameLayerScene
        frames = range(1 + d.FRAME_OFFSET, d.FRAME_OFFSET + d.FRAME_NUM + 1)
        boxes = np.zeros((d.FRAME_NUM + d.FRAME_OFFSET, d.LAYER_NUM, 2, 3), np.float32)
        for layer_id in range(d.LAYER_NUM + 1):
            per_frame = []
            for frame_id in frames:
                s = FrameLayerScene(cfg, transform, frame_id, layer_id)
                if layer_id != 0 and s.bbox is not None:
                    boxes[frame_id - 1, layer_id - 1] = s.bbox
                per_frame.append(s)
            self.layers.append(per_frame)

        base = self.layers[0][0]
        self.camera_num = base.cam_num
        self.poses = base.Ts.copy()
        # rescale intrinsics to the test image size by the width ratio
        # (ref: ray_dataset.py:237-242)
        col, _ = base.original_size()
        scale = cfg.INPUT.SIZE_TEST[0] / col
        self.Ks = base.Ks.copy()
        self.Ks[:, :2, :] *= scale
        self.width = cfg.INPUT.SIZE_TEST[0]
        self.height = cfg.INPUT.SIZE_TEST[1]
        self.near_far = np.array([d.FIXED_NEAR, d.FIXED_FAR], np.float32)

        self._boxes = boxes
        self.scene_boxes = _scene_boxes(base, boxes, device)

    def layer_center(self, layer_id: int, frame_idx: int) -> np.ndarray:
        return self.layers[layer_id][frame_idx].center

    def rays_for_pose(self, pose: np.ndarray, K: np.ndarray,
                      layer_frame_pairs) -> RayInputs:
        """Full-image rays with per-layer frame ids, as numpy arrays
        (ref: get_rays_by_pose_and_K, ray_dataset.py:260-283).

        ``layer_frame_pairs``: iterable of (layer_id, frame_id); hidden
        layers may be absent — they keep frame id 1 (their field is masked
        out at render time anyway).
        """
        rays = pixel_rays(np.asarray(K, np.float32), np.asarray(pose, np.float32),
                          self.height, self.width)
        n = rays.shape[0]
        frame_ids = np.ones((n, self.layer_num + 1), np.float32)
        for layer_id, frame_id in layer_frame_pairs:
            frame_ids[:, layer_id] = frame_id
        near_far = np.tile(self.near_far[None], (n, 1))
        return RayInputs(rays[:, :3], rays[:, 3:6], frame_ids,
                         np.zeros(n, np.float32), near_far)

    def get_image_label(self, camera_id: int, frame_idx: int):
        img, lab, *_ = self.layers[0][frame_idx].get_data(camera_id)
        return img, lab


class ViewScene:
    """Validation views: one full labeled image with its rays
    (ref: Ray_Dataset_View, data/datasets/ray_dataset.py:85-201)."""

    def __init__(self, cfg):
        self.cfg = cfg
        d = cfg.DATASETS
        self.layer_num = d.LAYER_NUM
        self.frame_num = d.FRAME_NUM
        self.frame_offset = d.FRAME_OFFSET
        t = _test_transform(cfg)
        frames = range(1 + d.FRAME_OFFSET, d.FRAME_OFFSET + d.FRAME_NUM + 1)
        self.layers = [[FrameLayerScene(cfg, t, f, l) for f in frames]
                       for l in range(d.LAYER_NUM + 1)]
        self.camera_num = self.layers[0][0].cam_num

    def get_fixed_image(self, view: int, frame_idx: int):
        """-> (inputs: RayInputs of numpy arrays, rgbs (N,3), labels (N,),
        image (3,H,W))."""
        image, label, K, T, _, _, near_far, _ = \
            self.layers[0][frame_idx].get_data(view)
        _, H, W = image.shape
        rays = pixel_rays(K, T, H, W)
        n = rays.shape[0]
        frame_id = float(frame_idx + self.frame_offset + 1)
        inputs = RayInputs(rays[:, :3], rays[:, 3:6],
                           np.full((n, self.layer_num + 1), frame_id, np.float32),
                           np.full(n, float(view), np.float32),
                           np.tile(near_far, (n, 1)))
        rgbs = np.moveaxis(image, 0, -1).reshape(-1, 3)
        return inputs, rgbs, label.reshape(-1), image

    def get_random_image(self, rng: np.random.Generator):
        frame = int(rng.integers(0, self.frame_num))
        view = int(rng.integers(0, self.camera_num))
        return self.get_fixed_image(view, frame) + (view, frame)


def make_train_data(cfg, spec, rng=None, workers: int | None = None, device=None):
    """-> (pool dict, SceneBoxes on ``device``). The one-call training data
    entry point (ref: make_ray_data_loader, data/build.py:13-27).
    ``workers`` defaults to cfg.DATALOADER.NUM_WORKERS capped at the host
    CPU count."""
    device = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    if workers is None:
        workers = max(1, min(cfg.DATALOADER.NUM_WORKERS,
                             os.cpu_count() or 1))
    pool, boxes = build_ray_pool(cfg, spec, rng, workers=workers)
    bkgd = FrameLayerScene(cfg, _test_transform(cfg), 1 + cfg.DATASETS.FRAME_OFFSET, 0)
    return pool, _scene_boxes(bkgd, boxes, device)
