"""Camera file loaders and ray generation (host side, NumPy) — the port's
copy of ``stnerf_tpu/data/cameras.py``.

File formats follow the reference dataset layout: ``pose/RT_c2w.txt`` with
one camera per row as a flattened 3x4 camera-to-world matrix
(ref: data/datasets/utils.py:6-17), ``pose/K.txt`` with one 3x3 intrinsic
per row (ref: :20-40), and an optional per-camera 0/1 view-mask text file
(ref: :80-89).

Pixel convention matches the reference ray generator
(ref: utils/ray_sampling.py:22-72, utils/render_helpers.py:42-127): a ray
for pixel (row v, col u) has direction ``normalize(K^-1 [u, v, 1])`` rotated
into world by the c2w rotation; origins are the camera centers. Rays are
emitted row-major.
"""

from __future__ import annotations

import numpy as np


def load_camposes(path: str) -> np.ndarray:
    """RT_c2w.txt rows of 12 floats -> (M, 4, 4) c2w matrices."""
    flat = np.loadtxt(path)
    flat = flat.reshape(-1, 12)
    out = np.zeros((flat.shape[0], 4, 4), np.float32)
    out[:, :3, :] = flat.reshape(-1, 3, 4)
    out[:, 3, 3] = 1.0
    return out


def load_intrinsics(path: str) -> np.ndarray:
    """K.txt rows of 9 floats -> (M, 3, 3)."""
    flat = np.loadtxt(path)
    return flat.reshape(-1, 3, 3).astype(np.float32)


def load_view_mask(path: str) -> np.ndarray:
    return np.loadtxt(path, dtype=np.int64).reshape(-1)


def pixel_rays(K: np.ndarray, c2w: np.ndarray, h: int, w: int,
               roi: tuple[int, int, int, int] | None = None) -> np.ndarray:
    """Rays for all pixels (or an roi = (minh, maxh, minw, maxw) crop).

    Returns (N, 6) [origin, direction] row-major over the (cropped) grid.
    """
    minh, maxh, minw, maxw = roi if roi is not None else (0, h, 0, w)
    vs, us = np.meshgrid(np.arange(minh, maxh, dtype=np.float32),
                         np.arange(minw, maxw, dtype=np.float32), indexing="ij")
    pix = np.stack([us, vs, np.ones_like(us)], axis=-1)   # (H', W', 3)
    dirs = pix @ np.linalg.inv(K).T.astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs = dirs @ c2w[:3, :3].T
    o = np.broadcast_to(c2w[:3, 3], dirs.shape)
    return np.concatenate([o, dirs], axis=-1).reshape(-1, 6).astype(np.float32)


def pixel_rays_at(K: np.ndarray, c2w: np.ndarray, us: np.ndarray,
                  vs: np.ndarray) -> np.ndarray:
    """Rays for an explicit pixel set (same convention as :func:`pixel_rays`).

    us, vs: (N,) integer/float pixel columns and rows. Returns (N, 6)
    [origin, direction] float32. Selection-first ray generation: computing
    rays only at kept pixels is ~20x less arithmetic than a full
    :func:`pixel_rays` grid followed by boolean indexing when the keep rate
    is low (background layers subsample at BKGD_SAMPLE_RATE ≈ 0.05).
    """
    pix = np.empty((us.shape[0], 3), np.float32)
    pix[:, 0] = us
    pix[:, 1] = vs
    pix[:, 2] = 1.0
    dirs = pix @ np.linalg.inv(K).T.astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs = dirs @ c2w[:3, :3].T.astype(np.float32)
    out = np.empty((us.shape[0], 6), np.float32)
    out[:, :3] = c2w[:3, 3]
    out[:, 3:] = dirs
    return out


def project_bbox_roi(bbox_corners: np.ndarray, K: np.ndarray, c2w: np.ndarray,
                     h: int, w: int) -> tuple[int, int, int, int]:
    """Project a 3-D bbox's 8 corners into the image and return the clipped
    pixel rectangle (minh, maxh, minw, maxw) enclosing it
    (ref: utils/ray_sampling.py:79-124)."""
    pts = np.asarray(bbox_corners, np.float64).reshape(-1, 3)
    w2c = np.linalg.inv(np.asarray(c2w, np.float64))
    cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
    pix = cam @ np.asarray(K, np.float64).T
    uv = pix[:, :2] / pix[:, 2:3]
    cols, rows = uv[:, 0], uv[:, 1]
    minh = int(np.clip(rows.min(), 0, h - 1))
    minw = int(np.clip(cols.min(), 0, w - 1))
    maxh = int(np.clip(rows.max(), 0, h - 1)) + 1
    maxw = int(np.clip(cols.max(), 0, w - 1)) + 1
    return minh, maxh, minw, maxw


def lookat(eye: np.ndarray, center: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Camera-to-world pose looking from ``eye`` at ``center``; OpenCV-style
    convention with flipped y/z columns to match the reference
    (ref: utils/render_helpers.py:5-30)."""
    eye = np.asarray(eye, np.float64)
    z = eye - np.asarray(center, np.float64)
    z /= np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float64), z)
    y = np.cross(z, x)
    x /= np.linalg.norm(x)
    y /= np.linalg.norm(y)
    c2w = np.eye(4)
    c2w[:3, 0] = x
    c2w[:3, 1] = -y
    c2w[:3, 2] = -z
    c2w[:3, 3] = eye
    return c2w.astype(np.float32)


def spherical_position(radius: float, theta: float, phi: float,
                       degree: bool = True) -> np.ndarray:
    """Point on a sphere (ref: utils/render_helpers.py:33-40)."""
    if degree:
        theta, phi = np.deg2rad(theta), np.deg2rad(phi)
    return np.array([radius * np.cos(theta) * np.sin(phi),
                     radius * np.sin(theta),
                     radius * np.cos(theta) * np.cos(phi)], np.float32)
