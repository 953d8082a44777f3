"""Image and video writers (host side) — the port's counterpart of
``stnerf_tpu/render/video.py``.

Frames are PNG files written by the port's own codec (``data/png.py``):
colour as RGB, depth as greyscale. The JAX package writes colour frames as
JPEG through PIL; the port has no JPEG encoder. A video is encoded only
where imageio or OpenCV imports; otherwise the frames on disk are the
output.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from ..data.png import write_png

_log = logging.getLogger("stnerf_tpu_torch.render")


def to_uint8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def write_image(path: str, img: np.ndarray) -> None:
    """A float [0, 1] or uint8 image as PNG: (H, W, 3) RGB, (H, W, 1) or
    (H, W) greyscale."""
    arr = to_uint8(img)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    write_png(path, arr)


def _optional_import(name: str):
    try:
        return __import__(name)
    except ImportError:
        return None


def write_video(path: str, frames, fps: int = 25) -> str | None:
    """Encode ``frames`` as an mp4 through imageio, or through OpenCV (an
    mp4, or an .avi beside it) where imageio is missing or has no ffmpeg
    backend -> the path written. Where neither imports, one log line says
    that the frames on disk are kept and no video is written -> None."""
    imageio, cv2 = _optional_import("imageio"), _optional_import("cv2")
    if imageio is None and cv2 is None:
        _log.warning("no video encoder (imageio or cv2) imports: kept the frames, "
                  "wrote no %s", path)
        return None
    frames = [to_uint8(f) for f in frames]
    if imageio is not None:
        try:
            imageio.mimwrite(path, frames, fps=fps, quality=8)
            return path
        except ValueError:  # no ffmpeg backend
            if cv2 is None:
                raise
    h, w = frames[0].shape[:2]
    for fourcc_name, suffix in (("mp4v", ".mp4"), ("MJPG", ".avi")):
        out_path = os.path.splitext(path)[0] + suffix
        vw = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*fourcc_name),
                             fps, (w, h))
        if not vw.isOpened():
            continue
        for f in frames:
            if f.ndim == 2:
                f = np.stack([f] * 3, -1)
            vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        vw.release()
        return out_path
    raise RuntimeError(f"cv2 has no usable video writer for {path}")
