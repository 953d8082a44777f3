from .encoding import (encoding_dim, lerp_encoded_time_planar,
                       positional_encoding_planar)
from .metrics import mae, mse, psnr, ssim
from .sampling import (MISS_T, ray_aabb_intersect, sample_pdf,
                       stratified_between, stratified_near_far)
from .volume import (RenderedRays, composite_merged_nosort, merge_layers_planar,
                     render_weights, sort_merge_t, volume_render_planar)

__all__ = [
    "encoding_dim", "lerp_encoded_time_planar", "positional_encoding_planar",
    "mae", "mse", "psnr", "ssim",
    "MISS_T", "ray_aabb_intersect", "sample_pdf", "stratified_between",
    "stratified_near_far",
    "RenderedRays", "composite_merged_nosort", "merge_layers_planar", "render_weights", "sort_merge_t",
    "volume_render_planar",
]
