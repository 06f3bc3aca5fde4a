"""The up-head tail, parity-packed, as a CUDA kernel (counterpart of
tgsr_tpu/ops/pallas_up_head.py `fused_up_head_packed`).

`fused_up_head_packed(x, wts, srb, a, use_tanh, blend)` computes what the
JAX function computes from (x, w_up, bn_mul, bn_add, w_head, srb, a): the
four weights come packed once by `packed_tail.pack_up_head`. x may be
float32 or bfloat16; products are summed in float32 and the image comes
back float32. One difference from JAX in bfloat16: JAX casts w_up to
bfloat16 before it fuses the taps (pallas_up_head.py:268), the port fuses
the float32 taps and casts the sums, which rounds once instead of twice.

On a CPU tensor the wrapper runs the plain version
(`packed_tail.packed_up_head`); on a CUDA tensor it launches
`csrc/up_head_packed.cu` or raises.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from tgsr_tpu_torch.ops import _build
from tgsr_tpu_torch.ops.blocks import nchw, nhwc
from tgsr_tpu_torch.ops.packed_tail import PackedUpHeadWeights, packed_up_head

NAME = "up_head_packed"


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
    # no alignment check: the kernel reads device memory element by element
    # (vector loads only from its own shared memory)
    code = _build.DTYPE_CODES[x.dtype]
    lib = _build.library(NAME)
    if lib.up_head_packed_smem_bytes(cin, c2, code) == 0:
        raise ValueError(f"fused_up_head_packed: Cin {cin}, C2 {c2} not "
                         "supported (C2 % 8, shared memory)")
    out = torch.empty((b, 2 * h, 2 * w, 3), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.up_head_packed_launch(
            x.data_ptr(), wts.w_up.data_ptr(), wts.bn_mul.data_ptr(),
            wts.bn_add.data_ptr(), wts.w_head.data_ptr(),
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
