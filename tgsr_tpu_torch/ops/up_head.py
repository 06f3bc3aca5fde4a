"""Fused up2 -> conv3x3 -> BN -> GLU -> image head (counterpart of
tgsr_tpu/ops/pallas_up_head.py `fused_up_head`).

`fused_up_head` takes the JAX package's layout (NHWC activations, HWIO
weights) and calls the custom op `tgsr::up_head` (`ops/library.py`), whose
CPU implementation is the plain version `reference_up_head` and whose CUDA
implementation launches `csrc/up_head.cu` or raises. The kernel writes only
the float32 [B, 2H, 2W, 3] image: the upsampled features never reach device
memory. `UpHeadSite` holds one generator site's folded (or packed)
weights as buffers, so that a serving module carries them into an
exported program.

The kernel runs the up-conv per output parity class as a GEMM on the
combined 2 x 2 weights of `fuse_upconv_kernel`, on the tensor cores in
3xTF32: each float32 operand v is split into big = rna_tf32(v) and small =
rna_tf32(v - big) (`split_tf32`, the rounding of `cvt.rna.tf32.f32`), and
big*big + big*small + small*big are summed in float32. The kernel splits the
activations in registers; `pack_upconv_weight` splits the combined weight and
lays it out in the kernel's mma fragment order, once per set of weights.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from tgsr_tpu_torch.ops import _build
from tgsr_tpu_torch.ops.blocks import (UpBlock, conv_hwio, glu, nchw, nhwc,
                                       upsample_nearest2x)
from tgsr_tpu_torch.ops.fused_upsample import fuse_upconv_kernel

NAME = "up_head"


def fold_bn(scale, bias, mean, var, eps: float = 1e-5):
    """Eval BatchNorm -> per-channel (mul, add)."""
    mul = scale * torch.rsqrt(var + eps)
    return mul, bias - mean * mul


def reference_up_head(x, w_up, bn_mul, bn_add, w_head, srb=None, a=None,
                      use_tanh: bool = False, blend: bool = False):
    """Plain version: nearest x2 -> conv3x3 (SAME) -> folded BN -> GLU ->
    k x k head (SAME) [-> tanh] [+ a * srb], a a scalar or a [2H, 2W] map.
    NHWC in, NHWC float32 out."""
    h = F.conv2d(nchw(upsample_nearest2x(x)), w_up.permute(3, 2, 0, 1), padding=1)
    return up_head_tail(h, bn_mul, bn_add, w_head, srb, a, use_tanh, blend)


def up_head_tail(h, bn_mul, bn_add, w_head, srb=None, a=None,
                 use_tanh: bool = False, blend: bool = False):
    """The part after the up-conv: NCHW conv output -> folded BN -> GLU ->
    k x k head (SAME) [-> tanh] [+ a * srb] -> NHWC float32; a is a scalar
    or a [2H, 2W] map (`blend_weight`)."""
    h = h * bn_mul[:, None, None] + bn_add[:, None, None]
    g = glu(h, dim=1)
    k = w_head.shape[0]
    y = F.conv2d(g, w_head.permute(3, 2, 0, 1), padding=k // 2)
    if use_tanh:
        y = torch.tanh(y)
    y = nhwc(y)
    if blend:
        y = y + blend_weight(a) * srb
    return y


def blend_weight(a):
    """The blend weight as it multiplies an NHWC srb: a scalar as it is, a
    [2H, 2W] map (EVAL.WEIGHTMAP) with a channel axis, broadcast over batch
    and channel."""
    return a[..., None] if torch.is_tensor(a) and a.dim() == 2 else a


def blend_ld(a: torch.Tensor, h: int, w: int, what: str) -> int:
    """The kernels' row stride of the blend weight: 0 for a scalar, 2W for
    a [2H, 2W] map; ValueError for any other shape."""
    if a.numel() == 1 and a.dim() <= 1:
        return 0
    if tuple(a.shape) == (2 * h, 2 * w):
        return 2 * w
    raise ValueError(f"{what}: a must be a scalar or a [2H, 2W] = [{2 * h}, {2 * w}] map, "
                     f"not {list(a.shape)}")


def _rna_tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero: half a TF32 ulp added to the magnitude's bits, the low 13 bits
    cleared (the sign bit is apart, so this rounds the magnitude)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 v -> (big, small), both TF32 values: big = rna_tf32(v), small =
    rna_tf32(v - big), with the rounding of `cvt.rna.tf32.f32`, as the kernel
    splits its operands. big + small keeps about 21 of v's 24 bits, and
    big*big + big*small + small*big is v*w to about float32 accuracy."""
    if v.dtype != torch.float32:
        raise TypeError("split_tf32 takes float32")
    big = _rna_tf32(v)
    return big, _rna_tf32(v - big)


def pack_upconv_weight(w_up: torch.Tensor) -> torch.Tensor:
    """HWIO [3, 3, Cin, C2] up-conv weight -> the kernel's combined weight,
    split into TF32 big and small parts, in mma fragment order:
    [4 class][4 tap][Cin / 8][C2 / 16][2 part][32 lane][4].

    Per parity class (di, dj) the combined weight is the GEMM operand B
    [K = 4 Cin, N = C2], K = (m * 2 + n) * Cin + ci for 2 x 2 tap (m, n)
    (`fuse_upconv_kernel`). For the k8 step s, part p (0 big, 1 small of
    `split_tf32`) and lane = 4 g + t, the four floats at [.., s, q, p,
    lane, :] are B[8s + t][16q + g], B[8s + t + 4][16q + g], B[8s + t][16q +
    8 + g], B[8s + t + 4][16q + 8 + g]: the b0, b1 fragments of n-tiles 2q
    and 2q + 1 of `mma.m16n8k8` tf32, one 16-byte load a lane. The weight is
    split once here, not by every warp of every block."""
    _, _, cin, c2 = w_up.shape
    if cin % 8 or c2 % 16:
        raise ValueError(f"pack_upconv_weight: Cin {cin} % 8 and C2 {c2} % 16 must be 0")
    b = fuse_upconv_kernel(w_up).reshape(2, 2, cin, 4, c2).permute(3, 0, 1, 2, 4)
    # [class, m, n, ci = (s, h, t), c = (q, jj, g)] -> [class, tap, s, q, g, t, jj, h]
    b = b.reshape(4, 4, cin // 8, 2, 4, c2 // 16, 2, 8)
    b = b.permute(0, 1, 2, 5, 7, 4, 6, 3).reshape(4, 4, cin // 8, c2 // 16, 1, 32, 4)
    return torch.cat(split_tf32(b), dim=4).contiguous()


class UpHeadWeights(NamedTuple):
    """The weights of one up-head site in `fused_up_head`'s layout, and the
    kernel's combined up-conv weight made from them (`prepare_up_head`)."""
    w_up: torch.Tensor  # [3, 3, Cin, C2]
    bn_mul: torch.Tensor  # [C2]
    bn_add: torch.Tensor  # [C2]
    w_head: torch.Tensor  # [k, k, C2 // 2, 3]
    w_frag: Optional[torch.Tensor] = None  # pack_upconv_weight(w_up); None: made per call


def prepare_up_head(w_up: torch.Tensor, bn_mul: torch.Tensor, bn_add: torch.Tensor,
                    w_head: torch.Tensor) -> UpHeadWeights:
    """One site's weights with the kernel's combined up-conv weight, made
    once from w_up (None where its layout does not fit: Cin % 8, C2 % 16)."""
    cin, c2 = w_up.shape[2:]
    w_frag = pack_upconv_weight(w_up) if cin % 8 == 0 and c2 % 16 == 0 else None
    return UpHeadWeights(w_up, bn_mul, bn_add, w_head, w_frag)


def fused_up_head(
    x: torch.Tensor,  # [B, H, W, Cin]
    w_up: torch.Tensor,  # [3, 3, Cin, C2]
    bn_mul: torch.Tensor,  # [C2] folded eval BN
    bn_add: torch.Tensor,  # [C2]
    w_head: torch.Tensor,  # [k, k, C2 // 2, 3]
    srb: Optional[torch.Tensor] = None,  # [B, 2H, 2W, 3]
    a: Optional[Union[torch.Tensor, float]] = None,  # scalar or [2H, 2W] blend weight
    use_tanh: bool = False,
    blend: bool = False,
) -> torch.Tensor:
    """Returns float32 [B, 2H, 2W, 3] = head(GLU(BN(conv(up2(x))))) [+a*srb].
    On a CUDA tensor the call makes the kernel's combined weight from w_up;
    `up_head_folded` takes it made once."""
    return up_head_folded(UpHeadWeights(w_up, bn_mul, bn_add, w_head), x, srb, a,
                          use_tanh=use_tanh, blend=blend)


def up_head_folded(
    wts: UpHeadWeights,
    x: torch.Tensor,  # [B, H, W, Cin]
    srb: Optional[torch.Tensor] = None,  # [B, 2H, 2W, 3]
    a: Optional[Union[torch.Tensor, float]] = None,  # scalar or [2H, 2W] blend weight
    use_tanh: bool = False,
    blend: bool = False,
) -> torch.Tensor:
    """`fused_up_head` on one site's weights; the kernel reads `wts.w_frag`,
    or the combined weight made here from `wts.w_up` when it is None."""
    w_up, bn_mul, bn_add, w_head, w_frag = wts
    _build.refuse_grad(NAME, x, srb, a, *wts)
    _build.check_device(x, "fused_up_head")
    if blend and a is not None and not torch.is_tensor(a):
        a = torch.tensor(float(a), device=x.device)
    if not blend:
        srb = a = None
    return torch.ops.tgsr.up_head(x, w_up, bn_mul, bn_add, w_head, w_frag, srb, a,
                                  use_tanh, blend)


@torch.library.custom_op("tgsr::up_head", mutates_args=(), device_types="cuda")
def _up_head_op(x: torch.Tensor, w_up: torch.Tensor, bn_mul: torch.Tensor,
                bn_add: torch.Tensor, w_head: torch.Tensor, w_frag: Optional[torch.Tensor],
                srb: Optional[torch.Tensor], a: Optional[torch.Tensor], use_tanh: bool,
                blend: bool) -> torch.Tensor:
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
    a_ld = 0
    if blend:
        if srb is None or a is None or tuple(srb.shape) != (b, 2 * h, 2 * w, 3):
            raise ValueError("fused_up_head: blend needs srb [B, 2H, 2W, 3] and a")
        a_ld = blend_ld(a, h, w, "fused_up_head")
        tensors += [srb, a]
    for t in tensors:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("fused_up_head: inputs must be contiguous and on "
                             "one device")
        if t.dtype != torch.float32:
            raise TypeError("fused_up_head: the kernel takes float32 only")
    lib = _build.library(NAME)
    if lib.up_head_smem_bytes(cin, c2, k) == 0:
        raise ValueError(f"fused_up_head: Cin {cin}, C2 {c2}, k {k} not "
                         "supported (Cin % 8, C2 16, 32 or 64, odd k, shared memory)")
    if w_frag is None:
        w_frag = pack_upconv_weight(w_up)
    if (w_frag.device != x.device or w_frag.dtype != torch.float32
            or tuple(w_frag.shape) != (4, 4, cin // 8, c2 // 16, 2, 32, 4)
            or not w_frag.is_contiguous()):
        raise ValueError("fused_up_head: w_frag must be pack_upconv_weight(w_up)")
    if x.data_ptr() % 16 or w_frag.data_ptr() % 16:
        raise ValueError("fused_up_head: x and w_frag must be 16-byte aligned")
    out = torch.empty((b, 2 * h, 2 * w, 3), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.up_head_launch(
            x.data_ptr(), w_frag.data_ptr(), bn_mul.data_ptr(), bn_add.data_ptr(),
            w_head.data_ptr(), srb.data_ptr() if blend else None,
            a.data_ptr() if blend else None, out.data_ptr(),
            b, h, w, cin, c2, k, int(use_tanh), a_ld,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, NAME)
    _build.LAUNCHES[NAME] += 1
    return out


@_up_head_op.register_kernel("cpu")
def _(x, w_up, bn_mul, bn_add, w_head, w_frag, srb, a, use_tanh, blend):
    return reference_up_head(x, w_up, bn_mul, bn_add, w_head, srb, a,
                             use_tanh=use_tanh, blend=blend).contiguous()


@_up_head_op.register_fake
def _(x, w_up, bn_mul, bn_add, w_head, w_frag, srb, a, use_tanh, blend):
    b, h, w, _ = x.shape
    return x.new_empty((b, 2 * h, 2 * w, 3), dtype=torch.float32)


@torch.no_grad()
def fold_up_head(up: UpBlock, head: nn.Conv2d) -> UpHeadWeights:
    """Folds the UpBlock's eval BN and lays both conv weights out as HWIO.
    Depends on the weights only: fold once, when the weights are final."""
    mul, add = fold_bn(up.bn.weight, up.bn.bias, up.bn.running_mean,
                       up.bn.running_var, up.bn.eps)
    return prepare_up_head(conv_hwio(up.conv), mul.contiguous(),
                           add.contiguous(), conv_hwio(head))


def up_head_site(wts: UpHeadWeights, x: torch.Tensor,
                 srb: Optional[torch.Tensor] = None,
                 a: Optional[torch.Tensor] = None,
                 use_tanh: bool = False) -> torch.Tensor:
    """A generator site whose upsampled features feed only an image head:
    `head(up(x))` [tanh] [+ a * srb] through `up_head_folded`. x and srb
    NCHW; returns the NCHW view of the NHWC image."""
    y = up_head_folded(wts, nhwc(x), nhwc(srb) if srb is not None else None,
                       a, use_tanh=use_tanh, blend=srb is not None)
    return nchw(y)


class UpHeadSite(nn.Module):
    """One generator site's weights as buffers with the function that runs
    them: `UpHeadSite(up_head_site, UpHeadWeights)` in float32, or
    `UpHeadSite(up_head_packed_site, PackedUpHeadWeights)` in bfloat16,
    called as `site(features NCHW, srb=, a=, use_tanh=) -> NCHW image`. A
    module, so that the weights travel with the serving module into an
    exported program."""

    def __init__(self, site: Callable[..., torch.Tensor], wts: tuple):
        super().__init__()
        self.site, self.weights = site, type(wts)
        for name, t in zip(wts._fields, wts):
            self.register_buffer(name, t)

    def forward(self, x: torch.Tensor, srb: Optional[torch.Tensor] = None,
                a: Optional[torch.Tensor] = None, use_tanh: bool = False) -> torch.Tensor:
        wts = self.weights(*(getattr(self, name) for name in self.weights._fields))
        return self.site(wts, x, srb, a, use_tanh)
