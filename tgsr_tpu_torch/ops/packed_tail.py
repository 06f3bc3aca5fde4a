"""The up-head tail in the parity-packed domain, plain PyTorch (counterpart
of tgsr_tpu/ops/packed_tail.py and of `pack_head_kernel` in
tgsr_tpu/ops/pallas_up_head.py).

    y = head_k(GLU(BN(conv3x3(nearest_up2(x))))) [-> tanh] [+ a * srb]

runs at the source resolution with 4x the channels: up2 + conv3x3 is one
2x2 conv to 4 * C2 class-major channels (`fuse_upconv_kernel`), BN and GLU
act per class, and the k x k head on the interleaved grid is one 3x3 conv on
the packed grid with a class-remapped kernel (`pack_head_kernel`, k in
{3, 5}); `depth_to_space` interleaves the 12 packed channels into the
[B, 2H, 2W, 3] image. SAME zero padding of the packed grid is SAME zero
padding of the interleaved grid.

`packed_up_head` is the plain version of the CUDA kernel in
`ops/up_head_packed.py`, and does its arithmetic: products of the working
type's values summed in float32, BN and GLU in float32, the GLU rounded to
the working type before the head (as the Pallas kernel does), a float32
image out.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from tgsr_tpu_torch.ops.blocks import depth_to_space, glu, nchw, nhwc
from tgsr_tpu_torch.ops.fused_upsample import fuse_upconv_kernel


def pack_head_kernel(wh: torch.Tensor) -> torch.Tensor:
    """[k, k, C, cout] head kernel (SAME conv on the interleaved 2x grid) ->
    [3, 3, 4C, 4 * cout] kernel on the packed grid.

    For output class q = (dy, dx) at packed pixel (I, J), interleaved tap
    (u, v) reads interleaved row 2I + dy + u - k // 2, which is packed row
    I + s of class parity pr with 2s + pr = dy + u - k // 2; for k in {3, 5}
    every s lies in {-1, 0, 1}."""
    k, _, c, cout = wh.shape
    hh = k // 2
    out = wh.new_zeros(3, 3, 4 * c, 4 * cout)
    for dy in range(2):
        for dx in range(2):
            q = dy * 2 + dx
            for u in range(k):
                pr, s_r = (dy + u - hh) % 2, (dy + u - hh) // 2
                if not -1 <= s_r <= 1:
                    raise ValueError("head kernel too large for 3x3 packed")
                for v in range(k):
                    pc, s_c = (dx + v - hh) % 2, (dx + v - hh) // 2
                    p = pr * 2 + pc
                    out[s_r + 1, s_c + 1, p * c:(p + 1) * c,
                        q * cout:(q + 1) * cout] += wh[u, v]
    return out


class PackedUpHeadWeights(NamedTuple):
    """One up-head site's weights in the packed layout (the JAX package's)."""
    w_up: torch.Tensor  # [2, 2, Cin, 4 * C2] fused up-conv, class-major
    bn_mul: torch.Tensor  # [C2] folded eval BN, float32
    bn_add: torch.Tensor  # [C2]
    w_head: torch.Tensor  # [3, 3, 4 * (C2 // 2), 12] class-remapped head


def pack_up_head(w_up: torch.Tensor, bn_mul: torch.Tensor, bn_add: torch.Tensor,
                 w_head: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> PackedUpHeadWeights:
    """Fuses the [3, 3, Cin, C2] up-conv and packs the [k, k, C2 // 2, 3]
    head from float32 weights, then casts both to `dtype`; BN stays float32.
    Depends on the weights only: pack once, when the weights are final."""
    w_up, w_head = w_up.float(), w_head.float()
    return PackedUpHeadWeights(
        fuse_upconv_kernel(w_up).to(dtype).contiguous(),
        bn_mul.float().contiguous(), bn_add.float().contiguous(),
        pack_head_kernel(w_head).to(dtype).contiguous())


def upconv2x_packed(x: torch.Tensor, w_fused: torch.Tensor) -> torch.Tensor:
    """conv3x3(nearest_up2(x)) in packed form: [B, H, W, Cin] ->
    [B, H, W, 4 * Cout], class-major channels, no depth_to_space."""
    y = nhwc(F.conv2d(F.pad(nchw(x), (1, 1, 1, 1)), w_fused.permute(3, 2, 0, 1)))
    cout = w_fused.shape[-1] // 4
    return torch.cat([y[:, :-1, :-1, 0 * cout:1 * cout],
                      y[:, :-1, 1:, 1 * cout:2 * cout],
                      y[:, 1:, :-1, 2 * cout:3 * cout],
                      y[:, 1:, 1:, 3 * cout:4 * cout]], dim=-1)


def packed_bn_glu(y4: torch.Tensor, bn_mul: torch.Tensor,
                  bn_add: torch.Tensor) -> torch.Tensor:
    """Per-channel BN affine + GLU on class-major packed channels:
    [B, H, W, 4 * C2] -> [B, H, W, 4 * (C2 // 2)]."""
    b, h, w, _ = y4.shape
    c2 = bn_mul.shape[0]
    g = glu(y4.reshape(b, h, w, 4, c2) * bn_mul + bn_add, dim=-1)
    return g.reshape(b, h, w, 4 * (c2 // 2))


def packed_head_conv(g: torch.Tensor, w_head_packed: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 head conv on the packed grid: [B, H, W, 4C] x
    [3, 3, 4C, 4 * cout] -> [B, H, W, 4 * cout], class-major."""
    return nhwc(F.conv2d(nchw(g), w_head_packed.permute(3, 2, 0, 1), padding=1))


def packed_up_head(x: torch.Tensor, wts: PackedUpHeadWeights,
                   srb: Optional[torch.Tensor] = None,
                   a: Optional[Union[torch.Tensor, float]] = None,
                   use_tanh: bool = False, blend: bool = False) -> torch.Tensor:
    """Plain version of the packed kernel: x [B, H, W, Cin] in the working
    type (float32 or bfloat16), `wts` in the same type, srb [B, 2H, 2W, 3].
    Returns float32 [B, 2H, 2W, 3]."""
    g = packed_bn_glu(upconv2x_packed(x.float(), wts.w_up.float()),
                      wts.bn_mul.float(), wts.bn_add.float())
    y = packed_head_conv(g.to(x.dtype).float(), wts.w_head.float())
    if use_tanh:
        y = torch.tanh(y)
    y = depth_to_space(y, 2)
    if blend:
        y = y + torch.as_tensor(a, device=y.device).float() * srb.float()
    return y
