"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Nothing is built or imported from CUDA when this package is imported: a
kernel's library is built and loaded on its first launch (``_build.py``).
"""

from .cross_trans import (cross_log_transmittance, cross_log_transmittance_bwd,
                          cross_log_transmittance_bwd_reference,
                          cross_log_transmittance_fwd,
                          cross_log_transmittance_reference, cross_successor,
                          cross_successor_reference)
from .field_vjp import (field_bwd, field_bwd_reference,
                        field_planar_trainable)
from .fused_field import (TILE, PackedField, fused_field,
                          fused_field_reference, pack_field,
                          prepare_kernel_params_planar,
                          prepare_motion_params_planar)
from .fused_spacenet import (fused_spacenet, fused_spacenet_planar,
                             fused_spacenet_planar_reference,
                             fused_spacenet_reference, fused_spacenet_stacked,
                             fused_spacenet_stacked_reference)
from .spacenet_vjp import (spacenet_bwd, spacenet_bwd_reference, spacenet_fwd,
                           spacenet_fwd_reference, spacenet_planar_trainable)

__all__ = ["cross_log_transmittance", "cross_log_transmittance_bwd",
           "cross_log_transmittance_bwd_reference",
           "cross_log_transmittance_fwd", "cross_log_transmittance_reference",
           "cross_successor", "cross_successor_reference",
           "field_bwd", "field_bwd_reference", "field_planar_trainable",
           "TILE", "PackedField", "fused_field", "fused_field_reference",
           "pack_field", "prepare_kernel_params_planar",
           "prepare_motion_params_planar",
           "fused_spacenet", "fused_spacenet_planar", "fused_spacenet_planar_reference",
           "fused_spacenet_reference", "fused_spacenet_stacked",
           "fused_spacenet_stacked_reference",
           "spacenet_bwd", "spacenet_bwd_reference", "spacenet_fwd",
           "spacenet_fwd_reference", "spacenet_planar_trainable"]
