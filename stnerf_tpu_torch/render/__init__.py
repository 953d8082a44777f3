from .bkgd_renderer import Mesh, MeshRender, load_textured_obj
from .chunked import render_rays_chunked
from .neural_renderer import FieldEntry, NeuralRenderer
from .paths import (lookat_path, lookat_path_centers, retime_frames,
                    smooth_pose_path, spherical_path)
from .pose_device import (QuantizedFrame, render_pose_host,
                          render_pose_on_device, tile_grid, tile_pixel_coords)
from .renderer import LayeredNeuralRenderer
from .video import to_uint8, write_image, write_video

__all__ = ["FieldEntry", "LayeredNeuralRenderer", "Mesh", "MeshRender", "NeuralRenderer",
           "QuantizedFrame", "load_textured_obj", "lookat_path",
           "lookat_path_centers", "render_pose_host", "render_pose_on_device",
           "render_rays_chunked", "retime_frames", "smooth_pose_path",
           "spherical_path", "tile_grid", "tile_pixel_coords", "to_uint8",
           "write_image", "write_video"]
