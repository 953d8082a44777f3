from .encoding import (encoding_dim, lerp_encoded_time_planar,
                       positional_encoding_planar)
from .metrics import mse, psnr
from .sampling import (MISS_T, ray_aabb_intersect, sample_pdf,
                       stratified_between, stratified_near_far)
from .volume import (RenderedRays, merge_layers_planar, render_weights,
                     sort_merge_t, volume_render_planar)

__all__ = [
    "encoding_dim", "lerp_encoded_time_planar", "positional_encoding_planar",
    "mse", "psnr",
    "MISS_T", "ray_aabb_intersect", "sample_pdf", "stratified_between",
    "stratified_near_far",
    "RenderedRays", "merge_layers_planar", "render_weights", "sort_merge_t",
    "volume_render_planar",
]
