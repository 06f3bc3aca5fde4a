"""The up-head tail, parity-packed, as a CUDA kernel (counterpart of
tgsr_tpu/ops/pallas_up_head.py `fused_up_head_packed`).

`fused_up_head_packed(x, wts, srb, a, use_tanh, blend)` computes what the
JAX function computes from (x, w_up, bn_mul, bn_add, w_head, srb, a): the
four weights come packed once by `prepare_up_head_packed`. x may be
float32 or bfloat16; products are summed in float32 and the image comes
back float32. One difference from JAX in bfloat16: JAX casts w_up to
bfloat16 before it fuses the taps (pallas_up_head.py:268), the port fuses
the float32 taps and casts the sums, which rounds once instead of twice.

On a CPU tensor the wrapper runs the plain version
(`packed_tail.packed_up_head`); on a CUDA tensor it launches
`csrc/up_head_packed.cu` or raises. In bfloat16 the kernel runs both convs
on the tensor cores (`mma.sync` m16n8k16) and reads both weights in its mma
fragment order (`pack_upconv_frag`, `pack_head_frag`; `unpack_upconv_frag`
and `unpack_head_frag` are their plain inverses), made once by
`prepare_up_head_packed` into `PackedUpHeadWeights.w_up_frag` and
`w_head_frag`, or per call when those are None. In float32 it runs the
first port's CUDA-core kernel on the plain packed weights.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from tgsr_tpu_torch.ops import _build
from tgsr_tpu_torch.ops.blocks import nchw, nhwc
from tgsr_tpu_torch.ops.packed_tail import PackedUpHeadWeights, pack_up_head, packed_up_head

NAME = "up_head_packed"
C2_TC = (16, 32, 64)  # the bfloat16 kernel's instances


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def pack_upconv_frag(w_up: torch.Tensor) -> torch.Tensor:
    """[2, 2, Cin, 4 * C2] fused up-conv (class-major columns, any dtype) ->
    the bfloat16 kernel's fragment order [4 class][4 tap][Kp / 16][C2 / 16]
    [32 lane][8], Kp = Cin rounded up to 16 with zero rows.

    Per class p the GEMM operand B is [K = Cin of tap (m, n) = (tap >> 1,
    tap & 1), N = C2], B[k][n] = w_up[m, n, k, p * C2 + n]. For the k16 step
    s, n pair q and lane = 4 g + t, the eight values at [p, tap, s, q, lane]
    are B[16s + 2t + {0, 1, 8, 9}][16q + g], then the same at column 16q + 8
    + g: the b0, b1 registers of n tiles 2q and 2q + 1 of `mma.m16n8k16`,
    one 16-byte load a lane."""
    _, _, cin, n4 = w_up.shape
    c2 = n4 // 4
    if c2 % 16:
        raise ValueError(f"pack_upconv_frag: C2 {c2} % 16 must be 0")
    kp = _pad16(cin)
    b = F.pad(w_up.reshape(4, cin, 4, c2).permute(2, 0, 1, 3), (0, 0, 0, kp - cin))
    # [class, tap, k = (s, h, t, e), n = (q, j, g)] -> [class, tap, s, q, g, t, j, h, e]
    b = b.reshape(4, 4, kp // 16, 2, 4, 2, c2 // 16, 2, 8)
    return b.permute(0, 1, 2, 6, 8, 4, 7, 3, 5).reshape(4, 4, kp // 16, c2 // 16, 32, 8).contiguous()


def unpack_upconv_frag(frag: torch.Tensor, cin: int) -> torch.Tensor:
    """The inverse of `pack_upconv_frag`: -> [2, 2, Cin, 4 * C2]."""
    ks, npair = frag.shape[2:4]
    b = frag.reshape(4, 4, ks, npair, 8, 4, 2, 2, 2)  # [class, tap, s, q, g, t, j, h, e]
    b = b.permute(0, 1, 2, 7, 5, 8, 3, 6, 4).reshape(4, 4, 16 * ks, 16 * npair)[:, :, :cin]
    return b.permute(1, 2, 0, 3).reshape(2, 2, cin, 4 * 16 * npair)


def pack_head_frag(w_head: torch.Tensor) -> torch.Tensor:
    """[3, 3, 4C, 12] packed head (any dtype) -> the bfloat16 kernel's
    fragment order [4 class][9 tap][Cp / 16][32 lane][8], Cp = C rounded up
    to 16 with zero rows, the 12 outputs padded to N = 16 with zeros.

    Per class p the head's operand B is [K = C of tap (u, v), N = 16],
    B[k][o] = w_head[u, v, p * C + k, o]; the eight values of a lane = 4 g +
    t at k16 step s are B[16s + 2t + {0, 1, 8, 9}][g], then the same at
    column 8 + g (the b0, b1 registers of both n tiles)."""
    c = w_head.shape[2] // 4
    cp = _pad16(c)
    b = F.pad(w_head.reshape(9, 4, c, 12).permute(1, 0, 2, 3), (0, 4, 0, cp - c))
    # [class, tap, k = (s, h, t, e), o = (j, g)] -> [class, tap, s, g, t, j, h, e]
    b = b.reshape(4, 9, cp // 16, 2, 4, 2, 2, 8)
    return b.permute(0, 1, 2, 7, 4, 6, 3, 5).reshape(4, 9, cp // 16, 32, 8).contiguous()


def unpack_head_frag(frag: torch.Tensor, c: int) -> torch.Tensor:
    """The inverse of `pack_head_frag`: -> [3, 3, 4C, 12]."""
    ks = frag.shape[2]
    b = frag.reshape(4, 9, ks, 8, 4, 2, 2, 2)  # [class, tap, s, g, t, j, h, e]
    b = b.permute(0, 1, 2, 6, 4, 7, 5, 3).reshape(4, 9, 16 * ks, 16)[:, :, :c, :12]
    return b.permute(1, 0, 2, 3).reshape(3, 3, 4 * c, 12)


def _fits_tc(cin: int, c2: int) -> bool:
    return cin % 8 == 0 and c2 in C2_TC


def prepare_up_head_packed(w_up: torch.Tensor, bn_mul: torch.Tensor, bn_add: torch.Tensor,
                           w_head: torch.Tensor,
                           dtype: torch.dtype = torch.float32) -> PackedUpHeadWeights:
    """`pack_up_head`, and in bfloat16 the kernel's fragment-ordered weights
    made from its packed weights (None where the kernel's layout does not
    fit: Cin % 8, C2 not 16, 32 or 64). Depends on the weights only: prepare
    once, when the weights are final."""
    wts = pack_up_head(w_up, bn_mul, bn_add, w_head, dtype=dtype)
    if dtype != torch.bfloat16 or not _fits_tc(w_up.shape[2], w_up.shape[3]):
        return wts
    return wts._replace(w_up_frag=pack_upconv_frag(wts.w_up),
                        w_head_frag=pack_head_frag(wts.w_head))


def fused_up_head_packed(
    x: torch.Tensor,  # [B, H, W, Cin] float32 or bfloat16
    wts: PackedUpHeadWeights,  # w_up and w_head in x's dtype, BN float32
    srb: Optional[torch.Tensor] = None,  # [B, 2H, 2W, 3] in x's dtype
    a: Optional[Union[torch.Tensor, float]] = None,  # scalar blend weight
    use_tanh: bool = False,
    blend: bool = False,
) -> torch.Tensor:
    """Returns float32 [B, 2H, 2W, 3] = head(GLU(BN(conv(up2(x))))) [+a*srb]."""
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"fused_up_head_packed: x is {x.dtype}; the kernel "
                        "takes float32 or bfloat16")
    if x.device.type == "cpu":
        return packed_up_head(x, wts, srb, a, use_tanh=use_tanh, blend=blend)
    if x.device.type != "cuda":
        raise ValueError(f"fused_up_head_packed: no kernel for {x.device}")
    if x.dim() != 4:
        raise ValueError("fused_up_head_packed: x must be [B, H, W, Cin]")
    b, h, w, cin = x.shape
    c2 = wts.bn_mul.shape[0]
    if (tuple(wts.w_up.shape) != (2, 2, cin, 4 * c2)
            or tuple(wts.w_head.shape) != (3, 3, 4 * (c2 // 2), 12)
            or tuple(wts.bn_add.shape) != (c2,)):
        raise ValueError("fused_up_head_packed: weight shapes do not match x")
    tensors = [(x, x.dtype), (wts.w_up, x.dtype), (wts.w_head, x.dtype),
               (wts.bn_mul, torch.float32), (wts.bn_add, torch.float32)]
    if blend:
        if srb is None or a is None or tuple(srb.shape) != (b, 2 * h, 2 * w, 3):
            raise ValueError("fused_up_head_packed: blend needs srb [B, 2H, 2W, 3] and a")
        if not torch.is_tensor(a):
            a = torch.tensor(float(a), dtype=x.dtype, device=x.device)
        if a.numel() != 1:
            raise ValueError("fused_up_head_packed: a must be a scalar")
        tensors += [(srb, x.dtype), (a, x.dtype)]
    for t, dtype in tensors:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("fused_up_head_packed: inputs must be contiguous "
                             "and on one device")
        if t.dtype != dtype:
            raise TypeError(f"fused_up_head_packed: a {t.dtype} input where "
                            f"the kernel takes {dtype}")
    w_up, w_head = wts.w_up, wts.w_head
    if x.dtype == torch.bfloat16:
        # the tensor-core kernel copies x and both weights 16 bytes at a time
        if not _fits_tc(cin, c2):
            raise ValueError(f"fused_up_head_packed: bfloat16 takes Cin % 8 == 0 and C2 in "
                             f"{C2_TC}, not Cin {cin}, C2 {c2}")
        w_up = wts.w_up_frag if wts.w_up_frag is not None else pack_upconv_frag(wts.w_up)
        w_head = wts.w_head_frag if wts.w_head_frag is not None else pack_head_frag(wts.w_head)
        if (w_up.shape != (4, 4, _pad16(cin) // 16, c2 // 16, 32, 8)
                or w_head.shape != (4, 9, _pad16(c2 // 2) // 16, 32, 8)
                or any(t.dtype != x.dtype or t.device != x.device or not t.is_contiguous()
                       for t in (w_up, w_head))):
            raise ValueError("fused_up_head_packed: w_up_frag and w_head_frag must be "
                             "pack_upconv_frag(w_up) and pack_head_frag(w_head)")
        if any(t.data_ptr() % 16 for t in (x, w_up, w_head)):
            raise ValueError("fused_up_head_packed: x and the fragment-ordered weights "
                             "must be 16-byte aligned")
    # float32: the CUDA-core kernel reads device memory element by element
    code = _build.DTYPE_CODES[x.dtype]
    lib = _build.library(NAME)
    if lib.up_head_packed_smem_bytes(cin, c2, code) == 0:
        raise ValueError(f"fused_up_head_packed: Cin {cin}, C2 {c2} not "
                         "supported (shared memory)")
    out = torch.empty((b, 2 * h, 2 * w, 3), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.up_head_packed_launch(
            x.data_ptr(), w_up.data_ptr(), wts.bn_mul.data_ptr(),
            wts.bn_add.data_ptr(), w_head.data_ptr(),
            srb.data_ptr() if blend else None, a.data_ptr() if blend else None,
            out.data_ptr(), b, h, w, cin, c2, int(use_tanh), code,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, NAME)
    _build.LAUNCHES[NAME] += 1
    return out


def up_head_packed_site(wts: PackedUpHeadWeights, x: torch.Tensor,
                        srb: Optional[torch.Tensor] = None,
                        a: Optional[torch.Tensor] = None,
                        use_tanh: bool = False) -> torch.Tensor:
    """A generator site whose upsampled features feed only an image head,
    through `fused_up_head_packed`. x and srb NCHW in the working type;
    returns the NCHW view of the image, cast to x's dtype (the dtype the
    unfused chain would give)."""
    y = fused_up_head_packed(nhwc(x), wts, nhwc(srb) if srb is not None else None,
                             a, use_tanh=use_tanh, blend=srb is not None)
    return nchw(y).to(x.dtype)
