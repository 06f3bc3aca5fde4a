"""int8 convolution with a dequantizing epilogue (counterpart of the XLA int8
convolutions of tgsr_tpu/engine/quant.py `quant_conv` and `_int8_seg_fn`).

`int8_conv(x, w, scale, bn, residual, out_dtype, up2)`: x int8 NHWC, the
weight int8 HWIO per output channel (`Int8Weight`), int32 sums, k 3 or 5,
SAME, stride 1; with `up2` on the nearest-x2 upsample of x. The epilogue, in
float32: acc * scale[c] (scale = x_step * w_step), then * mul[c] + add[c]
for a folded BN, then the cast to float32 or bfloat16, then + residual in
that type (as the JAX block adds its skip in its working type).

The wrapper calls the custom op `tgsr::int8_conv` (`ops/library.py`) on the
weight's two layouts. Its CPU implementation is the plain version:
`F.conv2d` in float64 on the int8 values, which is exact (every product and
partial sum is an integer below 2^53; at most 127^2 * 800 here), then int32,
then the same epilogue as separate torch ops. Its CUDA implementation
launches `csrc/int8_conv.cu` or raises; a float32 output is counted apart
(`int8_conv_f32`).
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
    plain version, `packed` int8 [N, Kp] for the kernel: one row a padded
    output channel (`cout_pad`), K contiguous and tap-major, column
    (ky * k + kx) * Cin_p + ci with Cin padded to `cin_pad`, zero beyond
    Cout and beyond k * k * Cin_p (Kp, a multiple of 32)."""

    q: torch.Tensor
    packed: torch.Tensor


def cin_pad(cin: int) -> int:
    """The input channels the kernel reads: 4 (taps folded into K) for up to
    4, else a multiple of 32 (one or more 32-byte k steps a tap)."""
    return 4 if cin <= 4 else -(-cin // 32) * 32


def cout_pad(cout: int) -> int:
    """The weight rows the kernel takes: its instances N = 8, 32, 64, 128."""
    for n in (8, 32, 64, 128):
        if cout <= n:
            return n
    raise ValueError(f"int8_conv: Cout {cout} > 128")


def pack_int8_weight(q: torch.Tensor) -> Int8Weight:
    """HWIO int8 [k, k, Cin, Cout] -> `Int8Weight`."""
    if q.dtype != torch.int8 or q.dim() != 4 or q.shape[0] != q.shape[1]:
        raise ValueError("pack_int8_weight: needs an int8 HWIO k x k weight")
    k, _, cin, cout = q.shape
    n, cp = cout_pad(cout), cin_pad(cin)
    rows = F.pad(q, (0, n - cout, 0, cp - cin)).permute(3, 0, 1, 2).reshape(n, k * k * cp)
    packed = F.pad(rows, (0, -(k * k * cp) % 32)).contiguous()
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


@torch.library.custom_op("tgsr::int8_conv", mutates_args=(), device_types="cuda")
def _int8_conv_op(x: torch.Tensor, q: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                  bn_mul: Optional[torch.Tensor], bn_add: Optional[torch.Tensor],
                  residual: Optional[torch.Tensor], out_dtype: torch.dtype,
                  up2: bool) -> torch.Tensor:
    b, h, wd, cin = x.shape
    k, _, cin_w, cout = q.shape
    if cin_w != cin or k not in (3, 5) or q.shape[1] != k:
        raise ValueError(f"int8_conv: weight {tuple(q.shape)} against x {tuple(x.shape)} "
                         "(k 3 or 5)")
    cp = cin_pad(cin)
    if cp != cin:
        x = F.pad(x, (0, cp - cin))
    ho, wo = (2 * h, 2 * wd) if up2 else (h, wd)
    tensors = [(x, torch.int8, (b, h, wd, cp)),
               (packed, torch.int8, (cout_pad(cout), -(-k * k * cp // 32) * 32)),
               (scale, torch.float32, (cout,))]
    if bn_mul is not None:
        tensors += [(bn_mul, torch.float32, (cout,)), (bn_add, torch.float32, (cout,))]
    if residual is not None:
        tensors.append((residual, out_dtype, (b, ho, wo, cout)))
    for t, dtype, shape in tensors:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("int8_conv: inputs must be contiguous and on one device")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"int8_conv: a {t.dtype} {tuple(t.shape)} input where the "
                             f"kernel takes {dtype} {shape}")
    if any(t.data_ptr() % 16 for t, _, _ in tensors if t.dim() > 1):
        raise ValueError("int8_conv: x, the weight and the residual must be 16-byte "
                         "aligned (the kernel copies 16 bytes at a time)")
    out = torch.empty((b, ho, wo, cout), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.library(NAME).int8_conv_launch(
            x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
            bn_mul.data_ptr() if bn_mul is not None else None,
            bn_add.data_ptr() if bn_add is not None else None,
            residual.data_ptr() if residual is not None else None,
            out.data_ptr(), b, h, wd, x.shape[-1], cout, k, int(up2),
            _build.DTYPE_CODES[out_dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(err, NAME)
    _build.LAUNCHES[NAME if out_dtype == torch.bfloat16 else NAME + "_f32"] += 1
    return out


@_int8_conv_op.register_kernel("cpu")
def _(x, q, packed, scale, bn_mul, bn_add, residual, out_dtype, up2):
    bn = (bn_mul, bn_add) if bn_mul is not None else None
    return int8_conv_plain(x, Int8Weight(q, packed), scale, bn, residual, out_dtype,
                           up2).contiguous()


@_int8_conv_op.register_fake
def _(x, q, packed, scale, bn_mul, bn_add, residual, out_dtype, up2):
    b, h, wd, _ = x.shape
    ho, wo = (2 * h, 2 * wd) if up2 else (h, wd)
    return x.new_empty((b, ho, wo, q.shape[3]), dtype=out_dtype)


def int8_conv(
    x: torch.Tensor,  # int8 [B, H, W, Cin]
    w: Int8Weight,
    scale: torch.Tensor,  # float32 [Cout]: x_step * w_step
    bn: Optional[BN] = None,  # float32 (mul [Cout], add [Cout])
    residual: Optional[torch.Tensor] = None,  # out_dtype [B, Ho, Wo, Cout]
    out_dtype: torch.dtype = torch.bfloat16,
    up2: bool = False,
) -> torch.Tensor:
    """Returns out_dtype [B, Ho, Wo, Cout], (Ho, Wo) = (H, W), or (2H, 2W)
    with up2."""
    if x.dtype != torch.int8 or x.dim() != 4:
        raise TypeError(f"int8_conv: x must be int8 [B, H, W, Cin], got {x.dtype} {tuple(x.shape)}")
    if out_dtype not in _build.DTYPE_CODES:
        raise TypeError(f"int8_conv: out_dtype {out_dtype}; the kernel writes float32 or bfloat16")
    if residual is not None and residual.dtype != out_dtype:
        raise TypeError(f"int8_conv: a {residual.dtype} residual to a {out_dtype} output; "
                        "the residual takes the output's type")
    _build.refuse_grad(NAME, scale, residual, *(bn or ()))
    _build.check_device(x, NAME)
    bn_mul, bn_add = bn if bn is not None else (None, None)
    return torch.ops.tgsr.int8_conv(x, w.q, w.packed, scale, bn_mul, bn_add, residual,
                                    out_dtype, up2)
