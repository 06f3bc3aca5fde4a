"""Compute-dtype casts (counterpart of tgsr_tpu/engine/precision.py
`cast_floats`, which the JAX pipeline applies to its generator trees)."""

from __future__ import annotations

import torch
from torch import nn

# the compute dtypes SRPipeline serves in
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def cast_floats(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Casts every floating-point parameter and buffer of `module` in place
    to `dtype`: weights, BN scale and bias, BN running mean and var, the
    blend `a`. Integer buffers (BN's num_batches_tracked) keep their type.
    A no-op for float32. Returns the module."""
    if dtype == torch.float32:
        return module
    return module.to(dtype)  # casts floating-point tensors only
