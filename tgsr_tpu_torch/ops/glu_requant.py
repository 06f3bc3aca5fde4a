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

Each is a custom op (`tgsr::glu_requant`, `tgsr::requant`; `ops/library.py`)
whose CPU implementation is its plain version and whose CUDA implementation
launches `csrc/glu_requant.cu` or raises: the `glu_requant_one` instance for
c = 64, `glu_requant_pair` for c = 32, `requant` for the flat pass, each in
bfloat16 or float32 by the input's type (counted apart, `_f32`). The kernel
loads 16 bytes at a time, so a CUDA tensor must be contiguous and 16-byte
aligned. The scale is a float argument of the op, so an exported program
carries it as a constant.
"""

from __future__ import annotations

import torch

from tgsr_tpu_torch.ops import _build
from tgsr_tpu_torch.ops.quantize import act_step, quantize_act

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


def _check_cuda(x: torch.Tensor, what: str) -> None:
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what}: the tensor must be contiguous and 16-byte aligned")


@torch.library.custom_op("tgsr::glu_requant", mutates_args=(), device_types="cuda")
def _glu_requant_op(h: torch.Tensor, scale: float) -> torch.Tensor:
    _check_cuda(h, "glu_requant")
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


@_glu_requant_op.register_kernel("cpu")
def _(h: torch.Tensor, scale: float) -> torch.Tensor:
    return glu_requant_plain(h, scale)


@_glu_requant_op.register_fake
def _(h: torch.Tensor, scale: float) -> torch.Tensor:
    return h.new_empty((*h.shape[:-1], h.shape[-1] // 2), dtype=torch.int8)


@torch.library.custom_op("tgsr::requant", mutates_args=(), device_types="cuda")
def _requant_op(x: torch.Tensor, scale: float) -> torch.Tensor:
    _check_cuda(x, "requant")
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    lib = _build.library(NAME)
    launch = lib.requant_f32_launch if x.dtype == torch.float32 else lib.requant_launch
    with torch.cuda.device(x.device):
        err = launch(x.data_ptr(), out.data_ptr(), x.numel(), act_step(scale),
                     torch.cuda.current_stream().cuda_stream)
    _build.check(err, NAME)
    _build.LAUNCHES["requant" + DTYPES[x.dtype]] += 1
    return out


@_requant_op.register_kernel("cpu")
def _(x: torch.Tensor, scale: float) -> torch.Tensor:
    return requant_plain(x, scale)


@_requant_op.register_fake
def _(x: torch.Tensor, scale: float) -> torch.Tensor:
    return x.new_empty(x.shape, dtype=torch.int8)


def glu_requant(h: torch.Tensor, scale: float) -> torch.Tensor:
    """h bfloat16 or float32 [..., 2c] -> int8 [..., c]."""
    if h.dtype not in DTYPES or h.shape[-1] % 2:
        raise TypeError(f"glu_requant: h must be bfloat16 or float32 [..., 2c], got {h.dtype} "
                        f"{tuple(h.shape)}")
    _build.refuse_grad("glu_requant", h)
    _build.check_device(h, "glu_requant")
    return torch.ops.tgsr.glu_requant(h, float(scale))


def requant(x: torch.Tensor, scale: float) -> torch.Tensor:
    """x bfloat16 or float32 -> int8 of the same shape."""
    if x.dtype not in DTYPES:
        raise TypeError(f"requant: x must be bfloat16 or float32, got {x.dtype}")
    _build.refuse_grad("requant", x)
    _build.check_device(x, "requant")
    return torch.ops.tgsr.requant(x, float(scale))
