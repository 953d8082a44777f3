"""Fused SpaceNet evaluation on encoded inputs — the port of the three entry
points of ``stnerf_tpu/kernels/fused_spacenet.py`` (K6).

All three compute the SpaceNet forward of ``spacenet_vjp`` (the TPU
``_kernel_planar`` is K3's forward with the same casts), so all three
launch K3's forward kernel: ``csrc/spacenet_tc.cu`` (tensor cores) for a
bf16 field, ``csrc/spacenet.cu`` (CUDA cores) for a float32 one:

* :func:`fused_spacenet_planar` — planar inputs (features, M), as
  :func:`spacenet_vjp.spacenet_fwd` (``fused_spacenet.py:245``);
* :func:`fused_spacenet` — row-major inputs (M, features), laid out planar
  for the kernel; returns rgb (M, 3) and sigma (M,) (``:139``);
* :func:`fused_spacenet_stacked` — L weight sets, one launch each, on
  inputs with a leading L axis (``:292``).

Each has its plain version beside it (``*_reference``) and its own launch
counts (``launches``, and ``launches_tc`` for the tensor-core route). The
operands are one ``PackedField`` per weight set (the fused field's packing
without a motion net); without a time input the time
encoding is ignored. On CPU tensors the wrappers run the plain versions; on
CUDA tensors they launch the kernel or raise.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .fused_field import PackedField
from .spacenet_vjp import counted_fwd, spacenet_fwd_reference


def _planar(x: torch.Tensor | None) -> torch.Tensor | None:
    return None if x is None else x.t().contiguous()


# the planar entry computes spacenet_fwd's function on its layout
fused_spacenet_planar_reference = spacenet_fwd_reference


def fused_spacenet_planar(field: PackedField, pos_enc: torch.Tensor,
                          dir_enc: torch.Tensor, time_enc: torch.Tensor | None = None):
    """pos_enc (pos_dim, M), dir_enc (dir_dim, M), time_enc (time_dim, M) or
    None, float32 -> (rgb (3, M), sigma (M,)), raw."""
    return counted_fwd(fused_spacenet_planar, field, pos_enc, dir_enc, time_enc)


fused_spacenet_planar.launches = 0
fused_spacenet_planar.launches_tc = 0


def fused_spacenet_reference(field: PackedField, pos_enc: torch.Tensor,
                             dir_enc: torch.Tensor, time_enc: torch.Tensor | None = None):
    """Plain version of :func:`fused_spacenet`."""
    rgb, sigma = spacenet_fwd_reference(field, pos_enc.t(), dir_enc.t(),
                                        None if time_enc is None else time_enc.t())
    return rgb.t(), sigma


def fused_spacenet(field: PackedField, pos_enc: torch.Tensor, dir_enc: torch.Tensor,
                   time_enc: torch.Tensor | None = None):
    """pos_enc (M, pos_dim), dir_enc (M, dir_dim), time_enc (M, time_dim) or
    None, float32 -> (rgb (M, 3), sigma (M,)), raw."""
    time_p = _planar(time_enc) if field.spec.use_time else None
    rgb, sigma = counted_fwd(fused_spacenet, field, _planar(pos_enc), _planar(dir_enc),
                             time_p)
    return rgb.t(), sigma


fused_spacenet.launches = 0
fused_spacenet.launches_tc = 0


def fused_spacenet_stacked_reference(fields: Sequence[PackedField], pos_enc: torch.Tensor,
                                     dir_enc: torch.Tensor,
                                     time_enc: torch.Tensor | None = None):
    """Plain version of :func:`fused_spacenet_stacked`."""
    outs = [fused_spacenet_reference(f, pos_enc[i], dir_enc[i],
                                     None if time_enc is None else time_enc[i])
            for i, f in enumerate(fields)]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def fused_spacenet_stacked(fields: Sequence[PackedField], pos_enc: torch.Tensor,
                           dir_enc: torch.Tensor, time_enc: torch.Tensor | None = None):
    """L weight sets on their own inputs: pos_enc (L, M, pos_dim), dir_enc
    (L, M, dir_dim), time_enc (L, M, time_dim) or None -> (rgb (L, M, 3),
    sigma (L, M)). One kernel launch per weight set."""
    if len(fields) != pos_enc.shape[0]:
        raise ValueError(f"{len(fields)} weight sets for {pos_enc.shape[0]} input sets")
    outs = [counted_fwd(fused_spacenet_stacked, f, _planar(pos_enc[i]), _planar(dir_enc[i]),
                        _planar(time_enc[i]) if f.spec.use_time else None)
            for i, f in enumerate(fields)]
    return torch.stack([o[0].t() for o in outs]), torch.stack([o[1] for o in outs])


fused_spacenet_stacked.launches = 0
fused_spacenet_stacked.launches_tc = 0
