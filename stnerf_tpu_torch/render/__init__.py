from .chunked import render_rays_chunked
from .pose_device import (QuantizedFrame, render_pose_host,
                          render_pose_on_device, tile_grid, tile_pixel_coords)

__all__ = ["QuantizedFrame", "render_pose_host", "render_pose_on_device",
           "render_rays_chunked", "tile_grid", "tile_pixel_coords"]
