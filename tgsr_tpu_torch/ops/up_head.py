"""Fused up2 -> conv3x3 -> BN -> GLU -> image head (counterpart of
tgsr_tpu/ops/pallas_up_head.py `fused_up_head`).

`fused_up_head` takes the JAX package's layout (NHWC activations, HWIO
weights). On a CPU tensor it runs the plain version `reference_up_head`; on
a CUDA tensor it launches `csrc/up_head.cu` or raises. The kernel writes only
the float32 [B, 2H, 2W, 3] image: the upsampled features never reach device
memory.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from tgsr_tpu_torch.ops import _build
from tgsr_tpu_torch.ops.blocks import (UpBlock, conv_hwio, glu, nchw, nhwc,
                                       upsample_nearest2x)

NAME = "up_head"


def fold_bn(scale, bias, mean, var, eps: float = 1e-5):
    """Eval BatchNorm -> per-channel (mul, add)."""
    mul = scale * torch.rsqrt(var + eps)
    return mul, bias - mean * mul


def reference_up_head(x, w_up, bn_mul, bn_add, w_head, srb=None, a=None,
                      use_tanh: bool = False, blend: bool = False):
    """Plain version: nearest x2 -> conv3x3 (SAME) -> folded BN -> GLU ->
    k x k head (SAME) [-> tanh] [+ a * srb]. NHWC in, NHWC float32 out."""
    h = F.conv2d(nchw(upsample_nearest2x(x)), w_up.permute(3, 2, 0, 1), padding=1)
    h = h * bn_mul[:, None, None] + bn_add[:, None, None]
    g = glu(h, dim=1)
    k = w_head.shape[0]
    y = F.conv2d(g, w_head.permute(3, 2, 0, 1), padding=k // 2)
    if use_tanh:
        y = torch.tanh(y)
    y = nhwc(y)
    if blend:
        y = y + a * srb
    return y


def fused_up_head(
    x: torch.Tensor,  # [B, H, W, Cin]
    w_up: torch.Tensor,  # [3, 3, Cin, C2]
    bn_mul: torch.Tensor,  # [C2] folded eval BN
    bn_add: torch.Tensor,  # [C2]
    w_head: torch.Tensor,  # [k, k, C2 // 2, 3]
    srb: Optional[torch.Tensor] = None,  # [B, 2H, 2W, 3]
    a: Optional[Union[torch.Tensor, float]] = None,  # scalar blend weight
    use_tanh: bool = False,
    blend: bool = False,
) -> torch.Tensor:
    """Returns float32 [B, 2H, 2W, 3] = head(GLU(BN(conv(up2(x))))) [+a*srb]."""
    if x.device.type == "cpu":
        return reference_up_head(x, w_up, bn_mul, bn_add, w_head, srb, a,
                                 use_tanh=use_tanh, blend=blend)
    if x.device.type != "cuda":
        raise ValueError(f"fused_up_head: no kernel for {x.device}")
    if x.dim() != 4:
        raise ValueError("fused_up_head: x must be [B, H, W, Cin]")
    b, h, w, cin = x.shape
    c2 = w_up.shape[-1]
    k = w_head.shape[0]
    if (tuple(w_up.shape) != (3, 3, cin, c2)
            or tuple(w_head.shape) != (k, k, c2 // 2, 3)
            or tuple(bn_mul.shape) != (c2,) or tuple(bn_add.shape) != (c2,)):
        raise ValueError("fused_up_head: weight shapes do not match x")
    tensors = [x, w_up, bn_mul, bn_add, w_head]
    if blend:
        if srb is None or a is None or tuple(srb.shape) != (b, 2 * h, 2 * w, 3):
            raise ValueError("fused_up_head: blend needs srb [B, 2H, 2W, 3] and a")
        if not torch.is_tensor(a):
            a = torch.tensor(float(a), device=x.device)
        if a.numel() != 1:
            raise ValueError("fused_up_head: a must be a scalar")
        tensors += [srb, a]
    for t in tensors:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("fused_up_head: inputs must be contiguous and on "
                             "one device")
        if t.dtype != torch.float32:
            raise TypeError("fused_up_head: the kernel takes float32 only")
    if w_up.data_ptr() % 16:
        raise ValueError("fused_up_head: w_up must be 16-byte aligned")
    lib = _build.library(NAME)
    if lib.up_head_smem_bytes(cin, c2, k) == 0:
        raise ValueError(f"fused_up_head: Cin {cin}, C2 {c2}, k {k} not "
                         "supported (C2 % 16, odd k, shared memory)")
    out = torch.empty((b, 2 * h, 2 * w, 3), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.up_head_launch(
            x.data_ptr(), w_up.data_ptr(), bn_mul.data_ptr(), bn_add.data_ptr(),
            w_head.data_ptr(), srb.data_ptr() if blend else None,
            a.data_ptr() if blend else None, out.data_ptr(),
            b, h, w, cin, c2, k, int(use_tanh),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, NAME)
    _build.LAUNCHES[NAME] += 1
    return out


class UpHeadWeights(NamedTuple):
    """The weights of one up-head site in `fused_up_head`'s layout."""
    w_up: torch.Tensor  # [3, 3, Cin, C2]
    bn_mul: torch.Tensor  # [C2]
    bn_add: torch.Tensor  # [C2]
    w_head: torch.Tensor  # [k, k, C2 // 2, 3]


@torch.no_grad()
def fold_up_head(up: UpBlock, head: nn.Conv2d) -> UpHeadWeights:
    """Folds the UpBlock's eval BN and lays both conv weights out as HWIO.
    Depends on the weights only: fold once, when the weights are final."""
    mul, add = fold_bn(up.bn.weight, up.bn.bias, up.bn.running_mean,
                       up.bn.running_var, up.bn.eps)
    return UpHeadWeights(conv_hwio(up.conv), mul.contiguous(),
                         add.contiguous(), conv_hwio(head))


def up_head_site(wts: UpHeadWeights, x: torch.Tensor,
                 srb: Optional[torch.Tensor] = None,
                 a: Optional[torch.Tensor] = None,
                 use_tanh: bool = False) -> torch.Tensor:
    """A generator site whose upsampled features feed only an image head:
    `head(up(x))` [tanh] [+ a * srb] through `fused_up_head`. x and srb
    NCHW; returns the NCHW view of the NHWC image."""
    y = fused_up_head(nhwc(x), *wts, nhwc(srb) if srb is not None else None,
                      a, use_tanh=use_tanh, blend=srb is not None)
    return nchw(y)
