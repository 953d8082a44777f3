"""Small utilities kept for reference-API completeness (counterpart of
``stnerf_tpu/utils/misc.py``)."""

from __future__ import annotations

import numpy as np
import torch


def add_two_dim_dict(adic: dict, key_a, key_b, val) -> None:
    """Nested-dict insertion helper (ref: utils/high_dim_dics.py:1-7)."""
    adic.setdefault(key_a, {})[key_b] = val


def add_three_dim_dict(adic: dict, key_a, key_b, key_c, val) -> None:
    """(ref: utils/high_dim_dics.py:9-14)."""
    adic.setdefault(key_a, {}).setdefault(key_b, {})[key_c] = val


@torch.no_grad()
def vis_density(net, bbox, L: int = 32, chunk: int = 65536) -> np.ndarray:
    """Grid-evaluate a field's density inside a bbox for point-cloud
    visualization (ref: utils/vis_density.py:3-28, which is broken for the
    layered model — it references a stale attribute; this takes any
    ``models.SpaceNet``, on its own device, through its forward).

    bbox: (2, 3) min/max. Returns (L, L, L) relu'd densities (numpy)."""
    device = next(net.parameters()).device
    bbox = np.asarray(bbox, np.float32)
    axes = [np.linspace(bbox[0, i], bbox[1, i], L, dtype=np.float32)
            for i in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([gx, gy, gz]).reshape(3, -1)  # planar (3, L^3)
    n = pts.shape[1]
    pts = np.pad(pts, ((0, 0), (0, (-n) % chunk)), mode="edge")
    out = []
    for i in range(0, pts.shape[1], chunk):
        p = torch.as_tensor(pts[:, i:i + chunk], device=device)
        # the direction input does not reach sigma; feed zeros
        times = torch.ones(p.shape[1], device=device) if net.spec.use_time else None
        _, sigma = net(p, torch.zeros_like(p), times)
        out.append(torch.relu(sigma).cpu().numpy())
    return np.concatenate(out)[:n].reshape(L, L, L)


def corrupt_cameras(cam_poses: np.ndarray, offset=(-0.1, 0.1),
                    rotation=(-5, 5), rng: np.random.Generator | None = None):
    """Perturb c2w poses with random translation/rotation — test harness for
    POSE_REFINEMENT training (ref: layers/camera_transform.py:6-40)."""
    rng = rng or np.random.default_rng()
    poses = np.asarray(cam_poses, np.float64)
    n = poses.shape[0]
    t_noise = rng.uniform(offset[0], offset[1], size=(n, 3))
    angles = np.deg2rad(rng.uniform(rotation[0], rotation[1], size=(n, 3)))

    out = poses.copy()
    out[:, :3, 3] += t_noise
    for i in range(n):
        ax, ay, az = angles[i]
        Rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)],
                       [0, np.sin(ax), np.cos(ax)]])
        Ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0],
                       [-np.sin(ay), 0, np.cos(ay)]])
        Rz = np.array([[np.cos(az), -np.sin(az), 0],
                       [np.sin(az), np.cos(az), 0], [0, 0, 1]])
        out[i, :3, :3] = Rz @ Ry @ Rx @ out[i, :3, :3]
    return out.astype(np.float32)
