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
