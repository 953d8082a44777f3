"""Learnable per-camera pose refinement (counterpart of
``stnerf_tpu/models/camera.py``).

A quaternion (x, y, z, w) and a translation per training camera, applied to
the ray directions and origins by camera id (ref:
layers/camera_transform.py:43-105). The products are elementwise sums, so
no matmul precision setting moves them.
"""

from __future__ import annotations

import torch
from torch import nn


class CameraTransform(nn.Module):
    """``rvec`` (C, 4) quaternions, initialised to the identity (0, 0, 0,
    1), and ``tvec`` (C, 3) translations, initialised to 0."""

    def __init__(self, num_cams: int):
        super().__init__()
        self.rvec = nn.Parameter(torch.tensor([0.0, 0.0, 0.0, 1.0]).repeat(num_cams, 1))
        self.tvec = nn.Parameter(torch.zeros(num_cams, 3))

    def forward(self, rays_o: torch.Tensor, rays_d: torch.Tensor, cam_ids: torch.Tensor):
        return apply_camera_transform(self, rays_o, rays_d, cam_ids)


def _rot_mats(rvec: torch.Tensor) -> torch.Tensor:
    """Quaternion (x, y, z, w) rows -> (C, 3, 3) rotation matrices, with the
    reference's soft normalisation (ref: layers/camera_transform.py:65-80)."""
    theta = torch.sqrt(1e-5 + (rvec ** 2).sum(1))
    q = rvec / theta[:, None]
    x, y, z, w = q.unbind(1)
    r = torch.stack([
        1 - 2 * y ** 2 - 2 * z ** 2, 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * x ** 2 - 2 * z ** 2, 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (x * w + y * z), 1 - 2 * x ** 2 - 2 * y ** 2,
    ], 1)
    return r.reshape(-1, 3, 3)


def apply_camera_transform(cam: CameraTransform, rays_o: torch.Tensor,
                           rays_d: torch.Tensor, cam_ids: torch.Tensor):
    """rays_o, rays_d (N, 3), cam_ids (N,) integral ids (float or int) ->
    refined (rays_o, rays_d)."""
    idx = cam_ids.long()
    R = _rot_mats(cam.rvec)[idx]                   # (N, 3, 3)
    d = (rays_d[:, None, :] * R).sum(-1)           # row-major contraction, as ref
    return rays_o + cam.tvec[idx], d
