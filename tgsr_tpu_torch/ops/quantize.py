"""The activation quantizer of the int8 path (counterpart of
tgsr_tpu/engine/quant.py `quantize_act`), apart from engine/quant.py so that
the kernel wrappers, and with them the custom ops of `ops/library.py`, import
no model module. engine/quant.py re-exports it."""

from __future__ import annotations

from typing import Tuple

import torch

QMAX = 127.0


def act_step(scale: float) -> float:
    """The activation step of a calibrated absmax, as a Python float (made
    float32 where it is used)."""
    return max(float(scale), 1e-12) / QMAX


def quantize_act(x: torch.Tensor, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric quantization: (int8 xq, float32 step) with
    x ~= xq * step; divides by the step (no reciprocal), rounds half to
    even after the clip."""
    step = torch.tensor(act_step(scale), dtype=torch.float32, device=x.device)
    xq = torch.round(torch.clamp(x.float() / step, -QMAX, QMAX)).to(torch.int8)
    return xq, step
