"""Packed-ray compatibility shim (counterpart of ``stnerf_tpu/models/rays.py``).

The reference carries camera and frame ids as extra ray columns whose
meaning depends on runtime flags (ref: modeling/layered_rfrender.py:144-181,
data/datasets/ray_dataset.py:405-418, 276-281); the port's core takes the
explicit :class:`RayInputs`. :func:`unpack_rays` translates.
"""

from __future__ import annotations

import numpy as np
import torch

from .layered import LayeredSpec, RayInputs


def unpack_rays(rays, spec: LayeredSpec, near_far=None, device=None) -> RayInputs:
    """Decode a packed (N, K) ray array into RayInputs on ``device``.

    Layouts (K = rays.shape[-1]): the base [o, d] (6 wide), then with
    deform-time or space-time one frame-id column, or L+1 per-layer ids
    (retiming). The pose-refinement and view-deform layouts are refused
    (``LayeredSpec`` does not port them).
    """
    rays = torch.as_tensor(np.asarray(rays, np.float32), device=device)
    n, k = rays.shape
    lp1 = spec.layer_num + 1
    o, d = rays[:, 0:3], rays[:, 3:6]
    frame_ids = torch.ones((n, lp1), dtype=torch.float32, device=rays.device)
    col = 6
    if spec.use_deform_time or spec.use_space_time:
        rest = k - col
        if rest == 1:
            frame_ids = rays[:, col:col + 1].expand(n, lp1).contiguous()
        elif rest == lp1:
            frame_ids = rays[:, col:col + lp1]
        else:
            raise ValueError(f"undefined ray format: width {k}")
    elif k != col:
        raise ValueError(f"undefined ray format: width {k}")
    if near_far is None:
        near_far = torch.tensor([[0.0, 1.0]], device=rays.device).expand(n, 2)
    else:
        near_far = torch.as_tensor(np.asarray(near_far, np.float32),
                                   device=rays.device).reshape(n, 2)
    return RayInputs(o.contiguous(), d.contiguous(), frame_ids,
                     torch.zeros(n, dtype=torch.float32, device=rays.device),
                     near_far.contiguous())
