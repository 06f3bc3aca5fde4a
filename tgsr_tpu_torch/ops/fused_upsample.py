"""Nearest x2 upsample + conv3x3 as one 2x2 conv (counterpart of
tgsr_tpu/ops/fused_upsample.py `fuse_upconv_kernel`).

After a nearest x2 upsample, the output pixel (2i + di, 2j + dj) sees only
2 x 2 distinct source pixels, so the 3x3 taps that land on the same source
pixel collapse into one: per output parity class (di, dj) a 2x2 kernel of
summed taps. Source row offset m in {0, 1} collects the taps k with
(di + k - 1) // 2 == m - 1 + di.
"""

from __future__ import annotations

import torch

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
