"""Rounding to the compute dtype, as the JAX package's ``astype(dtype)``."""

from __future__ import annotations

import torch


def round_to(x: torch.Tensor, dtype) -> torch.Tensor:
    """Round a float32 tensor to ``dtype`` and back (identity for None or
    float32). With bf16 operands rounded this way, a float32 matmul equals
    a bf16 matmul with float32 accumulation: a product of two bf16 values
    is exact in float32."""
    if dtype is None or dtype == torch.float32:
        return x
    return x.to(dtype).float()


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 explicit mantissa bits) as the card's
    ``cvt.rna.tf32.f32`` does: to nearest, ties away from zero, the low 13
    bits zero. Finite inputs below the float32 maximum's last TF32 step."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def truncate_tf32(x: torch.Tensor) -> torch.Tensor:
    """The TF32 part of float32 values: the low 13 bits cleared, as a
    tensor core reads a float32 operand of a tf32 product."""
    return (x.float().contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple:
    """x -> (hi, lo), both TF32, as the float32 backward kernels split an
    operand (csrc/f32_bwd.cuh ``split``): hi = round_tf32(x), lo the TF32
    part of x - hi, so that |x - hi - lo| <= 2^-21 |x|."""
    hi = round_tf32(x)
    return hi, truncate_tf32(x.float() - hi)


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in float32 from 3xTF32 products, the plain version of the
    float32 backward kernels' tensor-core products: lo_a hi_b + hi_a lo_b +
    hi_a hi_b, each a float32 matmul of TF32 values (a product of two is
    exact in float32), lo_a lo_b dropped. Per entry |result - a @ b| <=
    (2^-19 + K * 2^-24) (|a| @ |b|) for a reduction of K terms: the dropped
    term and the two splits' remainders, then float32's sums."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return al @ bh + ah @ bl + ah @ bh
