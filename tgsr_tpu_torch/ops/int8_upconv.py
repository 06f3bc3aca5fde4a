"""The quantized UpBlock by phases (counterpart of the four XLA int8
convolutions and the epilogue of tgsr_tpu/engine/quant.py `_fused_up_int8`,
:250-305).

`int8_upconv_phases(x, w, scale, bn, out_scale, out_dtype)`: x int8 NHWC
[B, H, W, Cin] at the source resolution, the 2x2 kernel of the nearest-x2
upsample + conv3x3 (`fused_upsample.fuse_upconv_weight`), int8 per phase
and output channel (`Int8PhaseWeight`). Per phase p = 2 di + dj, the int32
sums of a VALID 2x2 conv over x padded (1 - di, di) x (1 - dj, dj); then in
float32: * scale[p Cout + c] (x_step * w_step), * mul + add for a folded
BN, GLU value * sigmoid(gate); with `out_scale` the quantize-dequantize of
that (its step max(out_scale, 1e-12) / 127); then the cast to float32 or
bfloat16, written to pixel (2i + di, 2j + dj): [B, 2H, 2W, Cout / 2].

The wrapper calls the custom op `tgsr::int8_upconv_phases`
(`ops/library.py`). Its CPU implementation is the plain version: four
float64 `F.conv2d` calls on the int8 values (exact: every sum is an integer
below 2^53), then the epilogue as torch ops. Its CUDA implementation
launches `csrc/int8_upconv.cu` (all four phases in one launch) or raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tgsr_tpu_torch.ops import _build
from tgsr_tpu_torch.ops.blocks import depth_to_space, nchw, nhwc
from tgsr_tpu_torch.ops.quantize import act_step, quantize_act

NAME = "int8_upconv"
LAUNCH_NAME = "int8_upconv_phases"
BN = Tuple[torch.Tensor, torch.Tensor]
PHASES = ((0, 0), (0, 1), (1, 0), (1, 1))


@dataclass(frozen=True)
class Int8PhaseWeight:
    """The int8 2x2 phase kernel in both layouts: `q` HWIO [2, 2, Cin,
    4 Cout] (channel p * Cout + c, as `fuse_upconv_weight` orders them) for
    the plain version, `packed` int8 [4, Cout, 4 Cin] for the kernel (one
    row a phase's output channel, K tap-major: (ty * 2 + tx) * Cin + ci)."""

    q: torch.Tensor
    packed: torch.Tensor


def pack_phase_weight(q: torch.Tensor) -> Int8PhaseWeight:
    if q.dtype != torch.int8 or q.dim() != 4 or tuple(q.shape[:2]) != (2, 2) \
            or q.shape[3] % 4:
        raise ValueError("pack_phase_weight: needs an int8 HWIO [2, 2, Cin, 4 Cout] weight")
    cin, cout = q.shape[2], q.shape[3] // 4
    packed = q.reshape(2, 2, cin, 4, cout).permute(3, 4, 0, 1, 2).reshape(4, cout, 4 * cin)
    return Int8PhaseWeight(q.contiguous(), packed.contiguous())


def int8_upconv_int32(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The plain int32 sums: x int8 NHWC, q [2, 2, Cin, 4 Cout] -> int32
    [4, B, H, W, Cout], phase-major."""
    xx = nchw(x).double()
    cout = q.shape[3] // 4
    out = []
    for p, (di, dj) in enumerate(PHASES):
        wp = q[..., p * cout:(p + 1) * cout].permute(3, 2, 0, 1).double()
        y = F.conv2d(F.pad(xx, (1 - dj, dj, 1 - di, di)), wp)
        out.append(nhwc(y.round()).to(torch.int32))
    return torch.stack(out)


def phases_epilogue(acc: torch.Tensor, scale: torch.Tensor, bn: Optional[BN] = None,
                    out_scale: Optional[float] = None,
                    out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """int32 [4, B, H, W, Cout] -> [B, 2H, 2W, Cout / 2] in `out_dtype`, as
    JAX's `_fused_up_int8` computes it: dequantize, BN, GLU per phase in
    float32, the phases packed on the channel axis, [quantize-dequantize,]
    the cast and the depth-to-space."""
    cout = acc.shape[-1]
    c2 = cout // 2
    hs = []
    for p in range(4):
        y = acc[p].float() * scale[p * cout:(p + 1) * cout]
        if bn is not None:
            y = y * bn[0] + bn[1]
        hs.append(y[..., :c2] * torch.sigmoid(y[..., c2:]))
    packed = torch.cat(hs, dim=-1)
    if out_scale is not None:
        q, step = quantize_act(packed, out_scale)
        packed = q.float() * step
    return depth_to_space(packed.to(out_dtype), 2)


def int8_upconv_plain(x, w: Int8PhaseWeight, scale, bn=None, out_scale=None,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    return phases_epilogue(int8_upconv_int32(x, w.q), scale, bn, out_scale, out_dtype)


def matches_plain(got: torch.Tensor, ref: torch.Tensor, out_step: Optional[float] = None,
                  pre: Optional[torch.Tensor] = None) -> Tuple[bool, float]:
    """The kernel's output `got` against `int8_upconv_plain`'s `ref`:
    float32 within 4 ulps, bfloat16 within one ulp (a sigmoid one ulp apart,
    rounded into the product); with an output step, a value one step off
    only where the GLU output before the requantize (`pre`, the plain
    version's float32 output with no out_scale) over the step lies within a
    2^-20 relative distance of a half. Returns (ok, max abs err). The card
    tests and chip_smoke.py hold the kernel to it."""
    err = (got.float() - ref.float()).abs()
    bits = 23 if got.dtype == torch.float32 else 7
    ulp = 2.0 ** (torch.floor(torch.log2(ref.float().abs().clamp_min(1e-30))) - bits)
    ok = err <= (4 if bits == 23 else 1) * ulp
    if out_step is not None:
        t = (pre.double() / out_step).abs()
        ok |= (err <= out_step * 1.0001) & ((t - t.floor() - 0.5).abs() <= 2.0 ** -20 * t)
    return bool(ok.all()), err.max().item()


@torch.library.custom_op("tgsr::int8_upconv_phases", mutates_args=(), device_types="cuda")
def _int8_upconv_op(x: torch.Tensor, q: torch.Tensor, packed: torch.Tensor,
                    scale: torch.Tensor, bn_mul: Optional[torch.Tensor],
                    bn_add: Optional[torch.Tensor], out_scale: Optional[float],
                    out_dtype: torch.dtype) -> torch.Tensor:
    b, h, wd, cin = x.shape
    cout = q.shape[3] // 4
    if q.shape[2] != cin or cin % 32 or not 32 <= cin <= 128 or cout % 16 \
            or not 16 <= cout <= 128:
        raise ValueError(f"int8_upconv_phases: weight {tuple(q.shape)} against x "
                         f"{tuple(x.shape)}; the kernel takes Cin a multiple of 32 up to 128 "
                         "and Cout a multiple of 16 up to 128")
    tensors = [(x, torch.int8, (b, h, wd, cin)), (packed, torch.int8, (4, cout, 4 * cin)),
               (scale, torch.float32, (4 * cout,))]
    if bn_mul is not None:
        tensors += [(bn_mul, torch.float32, (cout,)), (bn_add, torch.float32, (cout,))]
    for t, dtype, shape in tensors:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("int8_upconv_phases: inputs must be contiguous and on one device")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"int8_upconv_phases: a {t.dtype} {tuple(t.shape)} input where "
                             f"the kernel takes {dtype} {shape}")
    if x.data_ptr() % 16 or packed.data_ptr() % 16:
        raise ValueError("int8_upconv_phases: x and the weight must be 16-byte aligned "
                         "(the kernel copies 16 bytes at a time)")
    out = torch.empty((b, 2 * h, 2 * wd, cout // 2), dtype=out_dtype, device=x.device)
    step = act_step(out_scale) if out_scale is not None else 0.0
    with torch.cuda.device(x.device):
        err = _build.library(NAME).int8_upconv_launch(
            x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
            bn_mul.data_ptr() if bn_mul is not None else None,
            bn_add.data_ptr() if bn_add is not None else None,
            out.data_ptr(), b, h, wd, cin, cout, step, _build.DTYPE_CODES[out_dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, LAUNCH_NAME)
    _build.LAUNCHES[LAUNCH_NAME] += 1
    return out


@_int8_upconv_op.register_kernel("cpu")
def _(x, q, packed, scale, bn_mul, bn_add, out_scale, out_dtype):
    bn = (bn_mul, bn_add) if bn_mul is not None else None
    return int8_upconv_plain(x, Int8PhaseWeight(q, packed), scale, bn, out_scale,
                             out_dtype).contiguous()


@_int8_upconv_op.register_fake
def _(x, q, packed, scale, bn_mul, bn_add, out_scale, out_dtype):
    b, h, wd, _ = x.shape
    return x.new_empty((b, 2 * h, 2 * wd, q.shape[3] // 8), dtype=out_dtype)


def int8_upconv_phases(
    x: torch.Tensor,  # int8 [B, H, W, Cin]
    w: Int8PhaseWeight,
    scale: torch.Tensor,  # float32 [4 Cout]: x_step * w_step, phase-major
    bn: Optional[BN] = None,  # float32 (mul [Cout], add [Cout])
    out_scale: Optional[float] = None,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Returns out_dtype [B, 2H, 2W, Cout / 2]."""
    if x.dtype != torch.int8 or x.dim() != 4:
        raise TypeError(f"int8_upconv_phases: x must be int8 [B, H, W, Cin], got {x.dtype} "
                        f"{tuple(x.shape)}")
    if out_dtype not in _build.DTYPE_CODES:
        raise TypeError(f"int8_upconv_phases: out_dtype {out_dtype}; the kernel writes "
                        "float32 or bfloat16")
    _build.refuse_grad(LAUNCH_NAME, scale, *(bn or ()))
    _build.check_device(x, LAUNCH_NAME)
    bn_mul, bn_add = bn if bn is not None else (None, None)
    return torch.ops.tgsr.int8_upconv_phases(x, w.q, w.packed, scale, bn_mul, bn_add,
                                             out_scale, out_dtype)
