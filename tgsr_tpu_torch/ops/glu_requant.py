"""GLU + requantize to int8 (counterpart of examples/glu_pallas_probe.py
`glu_requant_one` / `glu_requant_pair`, the pass that tgsr_tpu/engine/quant.py
runs between a quantized block's conv1 and its int8 consumer).

`glu_requant(h, scale)`: h bfloat16 [..., 2c], value half first, then the
gate -> int8 [..., c] with, per element, s = bf16(sigmoid(float(g))),
v = bf16(v * s), q = int8(rint(clamp(float(v) / step, -127, 127))),
step = max(scale, 1e-12) / 127 as a float32. On a CPU tensor it runs the
plain version; on a CUDA tensor it launches `csrc/glu_requant.cu` or raises:
the `glu_requant_one` instance for c = 64 (one pixel a 256-byte row), the
`glu_requant_pair` instance for c = 32 (two pixels a row).
"""

from __future__ import annotations

import torch

from tgsr_tpu_torch.engine.quant import act_step
from tgsr_tpu_torch.ops import _build

NAME = "glu_requant"
# kernel instance (launch counter) by the channels of one GLU half
INSTANCES = {64: "glu_requant_one", 32: "glu_requant_pair"}


def glu_requant_plain(h: torch.Tensor, scale: float) -> torch.Tensor:
    c = h.shape[-1] // 2
    v, g = h[..., :c], h[..., c:]
    s = torch.sigmoid(g.float()).to(h.dtype)
    step = torch.tensor(act_step(scale), dtype=torch.float32, device=h.device)
    return torch.round(torch.clamp((v * s).float() / step, -127.0, 127.0)).to(torch.int8)


def glu_requant(h: torch.Tensor, scale: float) -> torch.Tensor:
    """h bfloat16 [..., 2c] -> int8 [..., c]."""
    if h.dtype != torch.bfloat16 or h.shape[-1] % 2:
        raise TypeError(f"glu_requant: h must be bfloat16 [..., 2c], got {h.dtype} "
                        f"{tuple(h.shape)}")
    if h.device.type == "cpu":
        return glu_requant_plain(h, scale)
    if h.device.type != "cuda":
        raise ValueError(f"glu_requant: no kernel for {h.device}")
    c = h.shape[-1] // 2
    if c not in INSTANCES:
        raise ValueError(f"glu_requant: c = {c}; the kernel's instances take c in "
                         f"{sorted(INSTANCES)}")
    if not h.is_contiguous() or h.data_ptr() % 8:
        raise ValueError("glu_requant: h must be contiguous and 8-byte aligned")
    out = torch.empty((*h.shape[:-1], c), dtype=torch.int8, device=h.device)
    with torch.cuda.device(h.device):
        err = _build.library(NAME).glu_requant_launch(
            h.data_ptr(), out.data_ptr(), h.numel() // (2 * c), c,
            act_step(scale), torch.cuda.current_stream().cuda_stream)
    _build.check(err, NAME)
    _build.LAUNCHES[INSTANCES[c]] += 1
    return out

