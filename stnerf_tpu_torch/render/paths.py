"""Camera-path authoring: SLERP rotations, B-spline translations, lerped
intrinsics, lookat/spherical paths and timeline (retiming) remaps — the
port's copy of ``stnerf_tpu/render/paths.py``.

Host-side NumPy/SciPy; the reference interleaves this logic into its
renderer class (ref: render/layered_neural_renderer.py:230-319 smooth paths,
:495-544 retiming; render/render_functions.py:190-219 pose paths).
"""

from __future__ import annotations

import numpy as np

from ..data.cameras import lookat, spherical_position


def smooth_pose_path(poses: np.ndarray, Ks, step_num: int,
                     around: bool = False):
    """Interpolate a smooth camera path through the given gt poses.

    Rotations: SLERP through all poses (``around=True``) or just the
    first/last pair; translations: smoothing cubic B-spline through all
    camera centers; intrinsics: linear blend of the first and last K
    (ref: layered_neural_renderer.py:230-306).
    Returns (poses (step_num, 4, 4), Ks (step_num, 3, 3)).
    """
    from scipy.interpolate import splev, splprep
    from scipy.spatial.transform import Rotation, Slerp

    poses = np.asarray(poses)
    n = poses.shape[0]
    Ts = poses[:, :3, 3]

    key_rots = poses[:, :3, :3] if around else poses[[0, -1], :3, :3]
    key_times = (np.arange(n) if around else np.array([0, n - 1])).astype(float)
    slerp = Slerp(key_times, Rotation.from_matrix(key_rots))
    times = np.linspace(0, n - 1, step_num)
    Rs = slerp(times).as_matrix()

    # spline degree must be < number of control points (the reference
    # crashes for short pose lists; clamp instead)
    tck, _ = splprep([Ts[:, 0], Ts[:, 1], Ts[:, 2]], k=min(3, n - 1))
    u = np.linspace(0, 1, step_num)
    centers = np.stack(splev(u, tck), axis=1)

    K0, K1 = np.asarray(Ks[0]), np.asarray(Ks[-1])
    out_poses = np.zeros((step_num, 4, 4), np.float32)
    out_Ks = np.zeros((step_num, 3, 3), np.float32)
    for i in range(step_num):
        out_poses[i, :3, :3] = Rs[i]
        out_poses[i, :3, 3] = centers[i]
        out_poses[i, 3, 3] = 1.0
        w = i / max(step_num - 1, 1)
        out_Ks[i] = (1 - w) * K0 + w * K1
    return out_poses, out_Ks


def lookat_path(start, end, step_num: int, center, up) -> np.ndarray:
    """Linear eye path from start to end, always looking at ``center``
    (ref: render_functions.py:190-199)."""
    start, end = np.asarray(start, float), np.asarray(end, float)
    return np.stack([lookat(start + (end - start) * i / max(step_num - 1, 1),
                            center, up) for i in range(step_num)])


def lookat_path_centers(start, end, centers, up) -> np.ndarray:
    """Same, but with a per-step lookat target (layer tracing;
    ref: render_functions.py:201-210)."""
    start, end = np.asarray(start, float), np.asarray(end, float)
    n = len(centers)
    return np.stack([lookat(start + (end - start) * i / max(n - 1, 1),
                            centers[i], up) for i in range(n)])


def spherical_path(radius, thetas, phis, center, up) -> np.ndarray:
    """Poses on a sphere around ``center`` (ref: render_functions.py:212-219)."""
    return np.stack([lookat(spherical_position(radius, th, ph) + np.asarray(center, float),
                            center, up) for th, ph in zip(thetas, phis)])


# Reference-name aliases (ref: render/render_functions.py:190-219)
generate_poses_by_path = lookat_path
generate_poses_by_path_center = lookat_path_centers
generate_poses_by_spherical = spherical_path


def retime_frames(frames, key_frames_layer, key_frames, min_frame: int,
                  max_frame: int):
    """Piecewise-linear timeline remap for one layer.

    ``key_frames`` are anchor times on the *output* timeline, mapped to
    ``key_frames_layer`` on the layer's own timeline; frames between anchors
    interpolate linearly, the ends anchor to the layer's min/max frame
    (ref: layered_neural_renderer.py:495-544). Returns the remapped frame for
    each entry of ``frames`` (rounded to int, as the reference does).
    """
    assert len(key_frames_layer) == len(key_frames)
    out = []
    for frame in frames:
        seg = None
        for idx, kf in enumerate(key_frames):
            if frame <= kf:
                seg = idx
                break
        if seg is None:            # after the last anchor
            lo_t, hi_t = key_frames[-1], max_frame
            lo_v, hi_v = key_frames_layer[-1], max_frame
        elif seg == 0:             # before the first anchor
            lo_t, hi_t = min_frame, key_frames[0]
            lo_v, hi_v = min_frame, key_frames_layer[0]
        else:
            lo_t, hi_t = key_frames[seg - 1], key_frames[seg]
            lo_v, hi_v = key_frames_layer[seg - 1], key_frames_layer[seg]
        w = (frame - lo_t) / (hi_t - lo_t) if hi_t != lo_t else 0.0
        out.append(round(w * (hi_v - lo_v) + lo_v))
    return out
