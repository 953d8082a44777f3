"""Joint image/label/K/T transforms (host side, NumPy) — the port's copy of
``stnerf_tpu/data/transforms.py``.

The reference's ``Random_Transforms`` augmentation (ref:
data/transforms/random_transforms.py:45-163) rotates the image about the
principal point, shifts it (centering a mask's centroid), crops it to the
target aspect ratio and resizes it, together with its label map and an ROI
validity map, and updates the intrinsics to match. The JAX package warps
with PIL; the port has no PIL, so it warps in NumPy with PIL's resampling
(``Pillow``'s ``Geometry.c`` and ``Resample.c``), which this module
reproduces:

- rotate and the AFFINE shift (:func:`_affine_bicubic`): every output pixel
  centre mapped back through the affine, then PIL's 4x4 bicubic with the
  a = -1 cubic, edge rows and columns clamped, taps outside the image read
  as 0 and the result truncated to u8;
- the resize (:func:`_resize_bicubic`): a separable convolution with the
  a = -0.5 cubic whose support widens by the downscale factor, in 22-bit
  fixed point, the horizontal pass first, each pass rounded to u8;
- labels (:func:`_affine_nearest`, :func:`_resize_nearest`): nearest, on
  PIL's coordinates (accumulated doubles or 16.16 fixed point).

Every shipped scene config sets SHIFT, MAXRATION and ROTATION to 0 and
stores its images at SIZE_TRAIN, where the transform is the identity and
takes a fast path.
"""

from __future__ import annotations

import math

import numpy as np

_PRECISION_BITS = 22  # Resample.c: 32 - 8 - 2


def _rotation_z(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)


def _rotate_matrix(angle_deg: float, center) -> list:
    """The inverse affine (output -> input) of PIL's ``Image.rotate(angle,
    center=center)``, computed as it computes it."""
    angle = -math.radians(angle_deg % 360.0)
    m = [round(math.cos(angle), 15), round(math.sin(angle), 15), 0.0,
         round(-math.sin(angle), 15), round(math.cos(angle), 15), 0.0]
    cx, cy = center
    m[2] = m[0] * -cx + m[1] * -cy + m[2] + cx
    m[5] = m[3] * -cx + m[4] * -cy + m[5] + cy
    return m


def _cubic(v1, v2, v3, v4, d):
    """PIL's transform bicubic (Geometry.c ``BICUBIC``, a = -1)."""
    p2 = -v1 + v3
    p3 = 2 * (v1 - v2) + v3 - v4
    p4 = -v1 + v2 - v3 + v4
    return v2 + d * (p2 + d * (p3 + d * p4))


def _affine_bicubic(img: np.ndarray, a: list) -> np.ndarray:
    """(H, W, C) u8 warped by the output -> input affine ``a`` as PIL's
    ``Image.transform(AFFINE, BICUBIC)``: zeros where the mapped centre
    falls outside the image."""
    h, w = img.shape[:2]
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float64) + 0.5,
                         np.arange(w, dtype=np.float64) + 0.5, indexing="ij")
    xin = a[0] * xs + a[1] * ys + a[2]
    yin = a[3] * xs + a[4] * ys + a[5]
    inside = (xin >= 0) & (xin < w) & (yin >= 0) & (yin < h)
    xin, yin = xin - 0.5, yin - 0.5
    x, y = np.floor(xin), np.floor(yin)
    dx, dy = (xin - x)[..., None], (yin - y)[..., None]
    x, y = x.astype(np.int64) - 1, y.astype(np.int64) - 1
    cols = [np.clip(x + k, 0, w - 1) for k in range(4)]
    src = img.astype(np.float64)

    def row(r):
        return _cubic(*(src[r, c] for c in cols), dx)

    v = [row(np.clip(y, 0, h - 1))]
    for k in (1, 2, 3):  # a row off the image repeats the one above it
        ok = ((y + k >= 0) & (y + k < h))[..., None]
        v.append(np.where(ok, row(np.clip(y + k, 0, h - 1)), v[-1]))
    out = np.clip(_cubic(*v, dy), 0.0, 255.0).astype(np.uint8)
    return np.where(inside[..., None], out, 0).astype(np.uint8)


def _affine_nearest(img: np.ndarray, a: list, out_hw=None) -> np.ndarray:
    """(H, W) u8 warped by ``a`` onto ``out_hw`` (default (H, W)) as PIL's
    nearest affine, zeros outside: a scale or shift (``a[1] == a[3] ==
    0``) accumulates its coordinates in doubles (``xo += a[0]``) and
    truncates them; any other affine steps in 16.16 fixed point."""
    src_h, src_w = img.shape
    h, w = out_hw or img.shape
    if a[1] == 0 and a[3] == 0:  # ImagingScaleAffine
        xs = np.cumsum(np.r_[a[2] + a[0] * 0.5, np.full(w - 1, a[0])])
        ys = np.cumsum(np.r_[a[5] + a[4] * 0.5, np.full(h - 1, a[4])])
        xi = np.where(xs < 0, -1, np.trunc(xs)).astype(np.int64)[None, :]
        yi = np.where(ys < 0, -1, np.trunc(ys)).astype(np.int64)[:, None]
    else:
        def fix(v):
            return int(math.floor(v * 65536.0 + 0.5))

        row, col = np.arange(h)[:, None], np.arange(w)[None, :]
        xi = (fix(a[2] + a[1] * 0.5 + a[0] * 0.5) + row * fix(a[1]) + col * fix(a[0])) >> 16
        yi = (fix(a[5] + a[4] * 0.5 + a[3] * 0.5) + row * fix(a[4]) + col * fix(a[3])) >> 16
    xi, yi = np.broadcast_arrays(xi, yi)
    ok = (xi >= 0) & (xi < src_w) & (yi >= 0) & (yi < src_h)
    return np.where(ok, img[np.clip(yi, 0, src_h - 1), np.clip(xi, 0, src_w - 1)],
                    0).astype(np.uint8)


def _crop(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """PIL's ``crop((0, 0, w, h))``: zeros past the image."""
    out = np.zeros((h, w) + img.shape[2:], np.uint8)
    hh, ww = min(h, img.shape[0]), min(w, img.shape[1])
    out[:hh, :ww] = img[:hh, :ww]
    return out


def _bicubic_filter(x: np.ndarray) -> np.ndarray:
    """Resample.c ``bicubic_filter`` (a = -0.5)."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _coeffs(in_size: int, out_size: int):
    """Resample.c ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` -> (tap
    indices (out, k), 22-bit fixed-point weights (out, k), 0 past a row's
    taps)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    k = np.arange(ksize)
    taps = k[None, :] < xmax[:, None]
    w = np.where(taps, _bicubic_filter((k[None, :] + xmin[:, None] - center[:, None] + 0.5)
                                       / filterscale), 0.0)
    ww = w.sum(1, keepdims=True)
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    fixed = np.trunc(w * (1 << _PRECISION_BITS) + np.where(w < 0, -0.5, 0.5)).astype(np.int64)
    return np.minimum(xmin[:, None] + k[None, :], in_size - 1), np.where(taps, fixed, 0)


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    idx, kk = _coeffs(img.shape[axis], out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    extra = (slice(None),) + (None,) * (src.ndim - 1)
    for k in range(idx.shape[1]):
        acc += src[idx[:, k]] * kk[:, k][extra]
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _resize_bicubic(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """PIL's ``resize((w, h), BICUBIC)`` of an 8-bit image: the horizontal
    pass, then the vertical, each skipped when its size is unchanged."""
    if img.shape[1] != w:
        img = _resample_axis(img, w, 1)
    if img.shape[0] != h:
        img = _resample_axis(img, h, 0)
    return img


def _resize_nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
    if img.shape[:2] == (h, w):
        return img
    return _affine_nearest(img, [img.shape[1] / w, 0.0, 0.0, 0.0, img.shape[0] / h, 0.0],
                           (h, w))


class JointTransform:
    """Callable mirroring the reference transform's signature.

    __call__(img: np.ndarray HxWx3 (or 4) uint8, K (3,3), T (4,4),
             label HxW or None, mask=None)
      -> (image (3, H', W') float[0,1], label (1, H', W') float,
          K', T', roi (1, H', W'))

    Draws from ``rng`` in the JAX package's order (shift x, shift y,
    rotation, ratio), so the same seed gives the same augmentation.
    """

    def __init__(self, size_hw: tuple[int, int], random_range: float = 0,
                 random_ratio: float = 0, random_rotation: float = 0,
                 is_train: bool = True, rng: np.random.Generator | None = None):
        self.size = tuple(size_hw)  # (H, W)
        self.random_range = random_range
        self.random_ratio = random_ratio
        self.random_rotation = random_rotation
        self.is_train = is_train
        self.rng = rng or np.random.default_rng()

    def __call__(self, img, K, T, label=None, mask=None):
        K = np.array(K, np.float32, copy=True)
        T = np.array(T, np.float32, copy=True)
        out_h, out_w = self.size
        arr = np.asarray(img)
        # Identity fast path: no augmentation and the image is already the
        # target size (all shipped configs: SHIFT/MAXRATION/ROTATION = 0).
        if (not self.random_range and not self.random_ratio
                and not self.random_rotation and mask is None
                and arr.ndim == 3 and arr.shape[:2] == (out_h, out_w)):
            image = np.moveaxis(arr[..., :3].astype(np.float32) / 255.0, -1, 0)
            roi = np.ones((1, out_h, out_w), np.float32)
            lab = None
            if label is not None:
                lab = np.asarray(label, np.float32)[None]
            return image, lab, K, T, roi

        height, width = arr.shape[:2]
        offset = (self.rng.integers(-self.random_range, self.random_range + 1)
                  if self.random_range else 0)
        offset2 = (self.rng.integers(-self.random_range, self.random_range + 1)
                   if self.random_range else 0)
        rotation = ((self.rng.random() - 0.5) * np.deg2rad(self.random_rotation)
                    if self.random_rotation else 0.0)
        ratio = (self.rng.random() * self.random_ratio + 1.0
                 if self.random_ratio else 1.0)

        # rotating the image about the principal point = rotating the camera
        # about its optical axis (ref: random_transforms.py:70-73)
        if rotation:
            T[:3, :3] = T[:3, :3] @ _rotation_z(rotation)

        m_scale = height / out_h
        cx = cy = 0.0
        if mask is not None and self.is_train:
            m = np.asarray(mask)
            if m.ndim == 3:
                m = m[..., 0]
            ys, xs = np.nonzero(m)
            if len(ys):
                cy, cx = ys.mean() - height / 2, xs.mean() - width / 2
        translation = (offset * m_scale - cx, offset2 * m_scale - cy)

        crop_h = int(height / ratio)
        crop_w = int(height * out_w / ratio / out_h)
        affines = []
        if rotation:
            affines.append(_rotate_matrix(np.rad2deg(rotation), (float(K[0, 2]),
                                                                 float(K[1, 2]))))
        if translation != (0.0, 0.0):
            affines.append([1, 0, -translation[0], 0, 1, -translation[1]])

        def warp(x, nearest: bool):
            for a in affines:
                x = _affine_nearest(x, a) if nearest else _affine_bicubic(x, a)
            x = _crop(x, crop_h, crop_w)
            return _resize_nearest(x, out_h, out_w) if nearest else \
                _resize_bicubic(x, out_h, out_w)

        rgb = arr[..., :3] if arr.ndim == 3 else np.repeat(arr[..., None], 3, -1)
        image = warp(rgb.astype(np.uint8), False).astype(np.float32) / 255.0
        roi = warp(np.full((height, width, 1), 255, np.uint8), False)[..., 0]
        roi = roi.astype(np.float32) / 255.0
        lab = None
        if label is not None:
            lab = warp(np.asarray(label, np.uint8), True).astype(np.float32)

        K[0, 2] += translation[0]
        K[1, 2] += translation[1]
        K *= out_h * ratio / height
        K[2, 2] = 1.0

        image = np.moveaxis(image, -1, 0)
        roi = roi[None]
        if lab is not None:
            lab = lab[None]
        return image, lab, K, T, roi
