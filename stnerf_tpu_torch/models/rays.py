"""Packed-ray compatibility shim (counterpart of ``stnerf_tpu/models/rays.py``).

The reference carries camera and frame ids as extra ray columns whose
meaning depends on runtime flags (ref: modeling/layered_rfrender.py:144-181,
data/datasets/ray_dataset.py:405-418, 276-281); the port's core takes the
explicit :class:`RayInputs`. :func:`unpack_rays` and :func:`pack_rays`
translate both ways.
"""

from __future__ import annotations

import numpy as np
import torch

from .layered import LayeredSpec, RayInputs


def unpack_rays(rays, spec: LayeredSpec, near_far=None, device=None) -> RayInputs:
    """Decode a packed (N, K) ray array into RayInputs on ``device``.

    Layouts (K = rays.shape[-1]):
      * with pose refinement the prefix is [o(3), cam, d(3), cam], 8 wide
        (ref: data/datasets/ray_dataset.py:407-410), else [o, d], 6 wide;
      * with view deformation a camera-id column follows the prefix;
      * with deform-time or space-time, one frame-id column, or L+1
        per-layer ids (retiming; ref: :276-281).
    """
    rays = torch.as_tensor(np.asarray(rays, np.float32), device=device)
    n, k = rays.shape
    lp1 = spec.layer_num + 1
    cam_ids = torch.zeros(n, dtype=torch.float32, device=rays.device)
    frame_ids = torch.ones((n, lp1), dtype=torch.float32, device=rays.device)
    if spec.pose_refinement:
        o, d, cam_ids, col = rays[:, 0:3], rays[:, 4:7], rays[:, 3], 8
    else:
        o, d, col = rays[:, 0:3], rays[:, 3:6], 6
    if spec.use_deform_view:
        cam_ids = rays[:, col]
        col += 1
    if spec.use_deform_time or spec.use_space_time:
        rest = k - col
        if rest == 1:
            frame_ids = rays[:, col:col + 1].expand(n, lp1).contiguous()
        elif rest == lp1:
            frame_ids = rays[:, col:col + lp1].contiguous()
        else:
            raise ValueError(f"undefined ray format: width {k}")
    elif k != col:
        raise ValueError(f"undefined ray format: width {k}")
    if near_far is None:
        near_far = torch.tensor([[0.0, 1.0]], device=rays.device).expand(n, 2)
    else:
        near_far = torch.as_tensor(np.asarray(near_far, np.float32),
                                   device=rays.device).reshape(n, 2)
    return RayInputs(o.contiguous(), d.contiguous(), frame_ids, cam_ids.contiguous(),
                     near_far.contiguous())


def pack_rays(inputs: RayInputs, spec: LayeredSpec, retiming: bool = False) -> np.ndarray:
    """Inverse of :func:`unpack_rays` (the reference's cache layout): a
    float32 (N, K) numpy array; ``retiming`` keeps the L+1 per-layer frame
    ids, else the first."""
    o, d = (np.asarray(t.detach().cpu()) for t in (inputs.rays_o, inputs.rays_d))
    cam = np.asarray(inputs.cam_ids.detach().cpu())[:, None]
    cols = [o, cam, d, cam] if spec.pose_refinement else [o, d]
    if spec.use_deform_view:
        cols.append(cam)
    if spec.use_deform_time or spec.use_space_time:
        f = np.asarray(inputs.frame_ids.detach().cpu())
        cols.append(f if retiming else f[:, :1])
    return np.concatenate(cols, axis=1).astype(np.float32)
