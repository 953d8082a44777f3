"""Joint image/label/K/T transforms (host side, NumPy) — the port's copy of
``stnerf_tpu/data/transforms.py``.

The reference's ``Random_Transforms`` augmentation (ref:
data/transforms/random_transforms.py:45-163) rotates, shifts, crops and
resizes the image, its label map and an ROI map together, with the
intrinsics updated to match. Every shipped scene config sets SHIFT,
MAXRATION and ROTATION to 0 and stores its images at SIZE_TRAIN, where the
transform is the identity: that path is ported. The warp itself (PIL
rotate, affine shift, crop and bicubic resize in the JAX package) is not
yet, and raises.
"""

from __future__ import annotations

import numpy as np


class JointTransform:
    """Callable mirroring the reference transform's signature.

    __call__(img: np.ndarray HxWx3 (or 4) uint8, K (3,3), T (4,4),
             label HxW or None, mask=None)
      -> (image (3, H', W') float[0,1], label (1, H', W') float,
          K', T', roi (1, H', W'))
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
        if (self.random_range or self.random_ratio or self.random_rotation
                or mask is not None):
            raise NotImplementedError(
                "the augmenting transform (SHIFT, MAXRATION, ROTATION, or a mask) is "
                "not ported to stnerf_tpu_torch yet")
        arr = np.asarray(img)
        if arr.ndim != 3 or arr.shape[:2] != (out_h, out_w):
            raise NotImplementedError(
                f"an image of shape {arr.shape} needs a resize to {(out_h, out_w)}; the "
                "resizing transform is not ported to stnerf_tpu_torch yet")
        image = np.moveaxis(arr[..., :3].astype(np.float32) / 255.0, -1, 0)
        roi = np.ones((1, out_h, out_w), np.float32)
        lab = None
        if label is not None:
            lab = np.asarray(label, np.float32)[None]
        return image, lab, K, T, roi
