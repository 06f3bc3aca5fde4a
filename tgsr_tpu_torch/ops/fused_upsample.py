"""Nearest x2 upsample + conv3x3 as one 2x2 conv (counterpart of
tgsr_tpu/ops/fused_upsample.py: `fuse_upconv_kernel`, `fuse_upconv_kernel_jnp`
as `fuse_upconv_weight`, `upconv2x_fused`).

After a nearest x2 upsample, the output pixel (2i + di, 2j + dj) sees only
2 x 2 distinct source pixels, so the 3x3 taps that land on the same source
pixel collapse into one: per output parity class (di, dj) a 2x2 kernel of
summed taps. Source row offset m in {0, 1} collects the taps k with
(di + k - 1) // 2 == m - 1 + di. The up-head kernels take the combined
weights of `fuse_upconv_kernel`; `UpBlock(fused=True)` (SRPipeline's
`fused_upsample`) and the int8 UpBlock by phases take `fuse_upconv_weight`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# per parity d: the 3x3 taps summed into 2x2 tap 0 and tap 1
_TAPS = {0: ((0,), (1, 2)), 1: ((0, 1), (2,))}


def fuse_upconv_kernel(w: torch.Tensor) -> torch.Tensor:
    """[3, 3, Cin, Cout] HWIO kernel of conv3x3(nearest_up2(x)) -> the
    equivalent [2, 2, Cin, 4 * Cout] kernel on the source grid, channels
    class-major: (di * 2 + dj) * Cout + c, the order of `depth_to_space`."""
    if tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"fuse_upconv_kernel needs a 3x3 kernel, got {tuple(w.shape)}")
    classes = []
    for di in range(2):
        for dj in range(2):
            classes.append(torch.stack([
                torch.stack([w[list(rows)][:, list(cols)].sum(dim=(0, 1))
                             for cols in _TAPS[dj]])
                for rows in _TAPS[di]]))
    return torch.cat(classes, dim=-1)


def _two_taps(w: torch.Tensor, d: int):
    """The 2 taps of parity d along w's first axis, summed in pairs in the
    JAX package's order (`fuse_upconv_kernel_jnp`)."""
    return (w[0], w[1] + w[2]) if d == 0 else (w[0] + w[1], w[2])


def fuse_upconv_weight(w: torch.Tensor) -> torch.Tensor:
    """`fuse_upconv_kernel` with the taps summed as
    tgsr_tpu/ops/fused_upsample.py `fuse_upconv_kernel_jnp` sums them (rows
    first, then columns, one pair at a time, in w's dtype), so a bfloat16
    kernel rounds as JAX's. [3, 3, Cin, Cout] HWIO -> [2, 2, Cin, 4 * Cout]."""
    if tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"fuse_upconv_weight needs a 3x3 kernel, got {tuple(w.shape)}")
    classes = []
    for di in range(2):
        rows = _two_taps(w, di)  # each [3 (cols), Cin, Cout]
        for dj in range(2):
            classes.append(torch.stack([torch.stack(_two_taps(r, dj)) for r in rows]))
    return torch.cat(classes, dim=-1)


def upconv2x_fused(x: torch.Tensor, w_fused: torch.Tensor) -> torch.Tensor:
    """conv3x3(nearest_up2(x)) as one 2x2 conv at the source resolution and
    a depth-to-space (counterpart of tgsr_tpu/ops/fused_upsample.py
    `upconv2x_fused`): x NCHW [B, Cin, H, W], w_fused HWIO [2, 2, Cin,
    4 * Cout] (`fuse_upconv_weight`) -> NCHW [B, Cout, 2H, 2W]. The source
    is padded by 1 on every side and convolved VALID to [H + 1, W + 1];
    class (di, dj) reads that grid offset by (di, dj), as JAX slices it."""
    b, _, h, w = x.shape
    cout = w_fused.shape[-1] // 4
    y = F.conv2d(F.pad(x, (1, 1, 1, 1)), w_fused.permute(3, 2, 0, 1))
    cls = [y[:, p * cout:(p + 1) * cout, di:di + h, dj:dj + w]
           for p, (di, dj) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1)))]
    out = torch.stack([torch.stack(cls[0:2], dim=-1), torch.stack(cls[2:4], dim=-1)], dim=3)
    return out.reshape(b, cout, 2 * h, 2 * w)
