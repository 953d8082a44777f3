"""The data path: scenes on disk, ray pools and validation views — the
port's copies of ``stnerf_tpu/data/`` (NumPy on the host; images through
the port's own PNG codec)."""

from .build import RenderScene, ViewScene, make_train_data
from .cameras import (load_camposes, load_intrinsics, load_view_mask,
                      lookat, pixel_rays, project_bbox_roi, spherical_position)
from .ply import read_ply_points, write_ply_points
from .png import png_size, read_png, write_png
from .raygen import (build_ray_pool, decode_pool_host, generate_frame_layer_rays,
                     prefill_ray_caches, transform_is_deterministic)
from .scene import FrameLayerScene, corners_from_minmax, minmax_from_corners
from .synthetic import make_synthetic_scene, synthetic_cfg
from .transforms import JointTransform

__all__ = [
    "RenderScene", "ViewScene", "make_train_data",
    "load_camposes", "load_intrinsics", "load_view_mask", "lookat", "pixel_rays",
    "project_bbox_roi", "spherical_position",
    "read_ply_points", "write_ply_points", "png_size", "read_png", "write_png",
    "build_ray_pool", "decode_pool_host", "generate_frame_layer_rays",
    "prefill_ray_caches", "transform_is_deterministic",
    "FrameLayerScene", "corners_from_minmax", "minmax_from_corners",
    "make_synthetic_scene", "synthetic_cfg", "JointTransform",
]
