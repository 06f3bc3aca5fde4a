"""int8 convolution with a dequantizing epilogue (counterpart of the XLA int8
convolutions of tgsr_tpu/engine/quant.py `quant_conv` and `_int8_seg_fn`).

`int8_conv(x, w, scale, bn, residual, out_dtype, up2)`: x int8 NHWC, the
weight int8 HWIO per output channel (`Int8Weight`), int32 sums, k 3 or 5,
SAME, stride 1; with `up2` on the nearest-x2 upsample of x. The epilogue, in
float32: acc * scale[c] (scale = x_step * w_step), then * mul[c] + add[c]
for a folded BN, then the cast to float32 or bfloat16, then + residual
(bfloat16 only).

On a CPU tensor the wrapper runs the plain version: `F.conv2d` in float64 on
the int8 values, which is exact (every product and partial sum is an integer
below 2^53; at most 127^2 * 800 here), then int32, then the same epilogue as
separate torch ops. On a CUDA tensor it launches `csrc/int8_conv.cu` or
raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tgsr_tpu_torch.ops import _build
from tgsr_tpu_torch.ops.blocks import nchw, nhwc

NAME = "int8_conv"
BN = Tuple[torch.Tensor, torch.Tensor]


@dataclass(frozen=True)
class Int8Weight:
    """An int8 conv weight in both layouts: `q` HWIO [k, k, Cin, Cout] for the
    plain version, `packed` int32 [k, k, ceil(Cin / 4), Cout] for the kernel
    (4 consecutive input channels a word, byte j = channel 4g + j, Cin
    zero-padded to a multiple of 4)."""

    q: torch.Tensor
    packed: torch.Tensor


def pack_int8_weight(q: torch.Tensor) -> Int8Weight:
    """HWIO int8 [k, k, Cin, Cout] -> `Int8Weight`."""
    if q.dtype != torch.int8 or q.dim() != 4:
        raise ValueError("pack_int8_weight: needs an int8 HWIO weight")
    k1, k2, cin, cout = q.shape
    pad = -cin % 4
    qp = F.pad(q, (0, 0, 0, pad)) if pad else q
    packed = (qp.reshape(k1, k2, (cin + pad) // 4, 4, cout).permute(0, 1, 2, 4, 3)
              .contiguous().view(torch.int32).reshape(k1, k2, (cin + pad) // 4, cout))
    return Int8Weight(q.contiguous(), packed)


def int8_conv_int32(x: torch.Tensor, q: torch.Tensor, up2: bool = False) -> torch.Tensor:
    """The plain int32 sums: x int8 NHWC, q int8 HWIO -> int32 NHWC."""
    xx = nchw(x).double()
    if up2:
        xx = F.interpolate(xx, scale_factor=2, mode="nearest")
    y = F.conv2d(xx, q.permute(3, 2, 0, 1).double(), padding=q.shape[0] // 2)
    return nhwc(y.round()).to(torch.int32)


def dequant_epilogue(acc: torch.Tensor, scale: torch.Tensor, bn: Optional[BN] = None,
                     residual: Optional[torch.Tensor] = None,
                     out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """int32 sums -> acc * scale [* mul + add] -> out_dtype [+ residual]."""
    y = acc.float() * scale
    if bn is not None:
        y = y * bn[0] + bn[1]
    y = y.to(out_dtype)
    return y + residual if residual is not None else y


def int8_conv_plain(x, w: Int8Weight, scale, bn=None, residual=None,
                    out_dtype=torch.bfloat16, up2=False) -> torch.Tensor:
    return dequant_epilogue(int8_conv_int32(x, w.q, up2), scale, bn, residual, out_dtype)


def int8_conv(
    x: torch.Tensor,  # int8 [B, H, W, Cin]
    w: Int8Weight,
    scale: torch.Tensor,  # float32 [Cout]: x_step * w_step
    bn: Optional[BN] = None,  # float32 (mul [Cout], add [Cout])
    residual: Optional[torch.Tensor] = None,  # bfloat16 [B, Ho, Wo, Cout]
    out_dtype: torch.dtype = torch.bfloat16,
    up2: bool = False,
) -> torch.Tensor:
    """Returns out_dtype [B, Ho, Wo, Cout], (Ho, Wo) = (H, W), or (2H, 2W)
    with up2."""
    if x.dtype != torch.int8 or x.dim() != 4:
        raise TypeError(f"int8_conv: x must be int8 [B, H, W, Cin], got {x.dtype} {tuple(x.shape)}")
    if out_dtype not in _build.DTYPE_CODES:
        raise TypeError(f"int8_conv: out_dtype {out_dtype}; the kernel writes float32 or bfloat16")
    if residual is not None and out_dtype != torch.bfloat16:
        raise TypeError("int8_conv: a residual is added to a bfloat16 output only")
    if x.device.type == "cpu":
        return int8_conv_plain(x, w, scale, bn, residual, out_dtype, up2)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv: no kernel for {x.device}")
    b, h, wd, cin = x.shape
    k, _, cin_w, cout = w.q.shape
    if cin_w != cin or k not in (3, 5) or w.q.shape[1] != k:
        raise ValueError(f"int8_conv: weight {tuple(w.q.shape)} against x {tuple(x.shape)} "
                         "(k 3 or 5)")
    if cin % 4:
        x = F.pad(x, (0, -cin % 4))
    ho, wo = (2 * h, 2 * wd) if up2 else (h, wd)
    tensors = [(x, torch.int8, (b, h, wd, cin + (-cin % 4))),
               (w.packed, torch.int32, (k, k, (cin + 3) // 4, cout)),
               (scale, torch.float32, (cout,))]
    if bn is not None:
        tensors += [(bn[0], torch.float32, (cout,)), (bn[1], torch.float32, (cout,))]
    if residual is not None:
        tensors.append((residual, torch.bfloat16, (b, ho, wo, cout)))
    for t, dtype, shape in tensors:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("int8_conv: inputs must be contiguous and on one device")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"int8_conv: a {t.dtype} {tuple(t.shape)} input where the "
                             f"kernel takes {dtype} {shape}")
    if x.data_ptr() % 4:
        raise ValueError("int8_conv: x must be 4-byte aligned (the kernel reads "
                         "4 channels a word)")
    out = torch.empty((b, ho, wo, cout), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.library(NAME).int8_conv_launch(
            x.data_ptr(), w.packed.data_ptr(), scale.data_ptr(),
            bn[0].data_ptr() if bn is not None else None,
            bn[1].data_ptr() if bn is not None else None,
            residual.data_ptr() if residual is not None else None,
            out.data_ptr(), b, h, wd, x.shape[-1], cout, k, int(up2),
            _build.DTYPE_CODES[out_dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(err, NAME)
    _build.LAUNCHES[NAME] += 1
    return out
