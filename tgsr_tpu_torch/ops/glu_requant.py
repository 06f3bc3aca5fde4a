"""GLU + requantize to int8 (counterpart of examples/glu_pallas_probe.py
`glu_requant_one` / `glu_requant_pair`, the pass that tgsr_tpu/engine/quant.py
runs between a quantized block's conv1 and its int8 consumer), and the
requantization alone (`quantize_act`, the input of every other int8 conv).

`glu_requant(h, scale)`: h bfloat16 or float32 [..., 2c], value half first,
then the gate -> int8 [..., c]. In bfloat16, per element,
s = bf16(sigmoid(float(g))), v = bf16(v * s), in float32 s = sigmoid(g),
v = v * s; then q = int8(rint(clamp(float(v) / step, -127, 127))),
step = max(scale, 1e-12) / 127 as a float32. `requant(x, scale)`: x bfloat16
or float32 -> int8 of the same shape, the last step alone, equal to
`engine.quant.quantize_act(x, scale)[0]` bit for bit.

On a CPU tensor each runs its plain version; on a CUDA tensor it launches
`csrc/glu_requant.cu` or raises: the `glu_requant_one` instance for c = 64,
`glu_requant_pair` for c = 32, `requant` for the flat pass, each in
bfloat16 or float32 by the input's type (counted apart, `_f32`). The kernel
loads 16 bytes at a time, so a CUDA tensor must be contiguous and 16-byte
aligned.
"""

from __future__ import annotations

import torch

from tgsr_tpu_torch.engine.quant import act_step, quantize_act
from tgsr_tpu_torch.ops import _build

NAME = "glu_requant"
# kernel instance (launch counter) by the channels of one GLU half
INSTANCES = {64: "glu_requant_one", 32: "glu_requant_pair"}
# the input types the kernels take, and the suffix of their launch counters
DTYPES = {torch.bfloat16: "", torch.float32: "_f32"}


def glu_requant_plain(h: torch.Tensor, scale: float) -> torch.Tensor:
    c = h.shape[-1] // 2
    v, g = h[..., :c], h[..., c:]
    s = torch.sigmoid(g.float()).to(h.dtype)
    return requant_plain(v * s, scale)


def requant_plain(x: torch.Tensor, scale: float) -> torch.Tensor:
    return quantize_act(x, scale)[0]


def _on_cpu(x: torch.Tensor, what: str) -> bool:
    """True for a CPU tensor (the plain version runs), False for one the
    kernel takes; raises for any other."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what}: the tensor must be contiguous and 16-byte aligned")
    return False


def glu_requant(h: torch.Tensor, scale: float) -> torch.Tensor:
    """h bfloat16 or float32 [..., 2c] -> int8 [..., c]."""
    if h.dtype not in DTYPES or h.shape[-1] % 2:
        raise TypeError(f"glu_requant: h must be bfloat16 or float32 [..., 2c], got {h.dtype} "
                        f"{tuple(h.shape)}")
    _build.refuse_grad("glu_requant", h)
    if _on_cpu(h, "glu_requant"):
        return glu_requant_plain(h, scale)
    c = h.shape[-1] // 2
    if c not in INSTANCES:
        raise ValueError(f"glu_requant: c = {c}; the kernel's instances take c in "
                         f"{sorted(INSTANCES)}")
    out = torch.empty((*h.shape[:-1], c), dtype=torch.int8, device=h.device)
    lib = _build.library(NAME)
    launch = lib.glu_requant_f32_launch if h.dtype == torch.float32 else lib.glu_requant_launch
    with torch.cuda.device(h.device):
        err = launch(h.data_ptr(), out.data_ptr(), h.numel() // (2 * c), c, act_step(scale),
                     torch.cuda.current_stream().cuda_stream)
    _build.check(err, NAME)
    _build.LAUNCHES[INSTANCES[c] + DTYPES[h.dtype]] += 1
    return out


def requant(x: torch.Tensor, scale: float) -> torch.Tensor:
    """x bfloat16 or float32 -> int8 of the same shape."""
    if x.dtype not in DTYPES:
        raise TypeError(f"requant: x must be bfloat16 or float32, got {x.dtype}")
    _build.refuse_grad("requant", x)
    if _on_cpu(x, "requant"):
        return requant_plain(x, scale)
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    lib = _build.library(NAME)
    launch = lib.requant_f32_launch if x.dtype == torch.float32 else lib.requant_launch
    with torch.cuda.device(x.device):
        err = launch(x.data_ptr(), out.data_ptr(), x.numel(), act_step(scale),
                     torch.cuda.current_stream().cuda_stream)
    _build.check(err, NAME)
    _build.LAUNCHES["requant" + DTYPES[x.dtype]] += 1
    return out
