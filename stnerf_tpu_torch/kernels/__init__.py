"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Nothing is built or imported from CUDA when this package is imported: a
kernel's library is built and loaded on its first launch (``_build.py``).
"""

from .fused_field import (TILE, PackedField, fused_field,
                          fused_field_reference, pack_field,
                          prepare_kernel_params_planar,
                          prepare_motion_params_planar)

__all__ = ["TILE", "PackedField", "fused_field", "fused_field_reference",
           "pack_field", "prepare_kernel_params_planar",
           "prepare_motion_params_planar"]
