"""Conv blocks of the generators (counterpart of tgsr_tpu/ops/blocks.py).

Modules run NCHW (channels_last memory on the card) and carry the
reference's Sequential layouts, so their state-dict keys are the reference
checkpoint's: an UpBlock is Sequential(Upsample, conv3x3, BN, GLU) with keys
`1.weight` and `2.*`; a ResBlock keeps its Sequential under `block.{0,1,3,4}`.
The free functions keep the JAX package's NHWC layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5


def glu(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Channel-halving gated linear unit: first half * sigmoid(second half).

    The halves split in the same order as the JAX package's `glu`, so
    converted weights give the same values."""
    nc = x.shape[dim]
    if nc % 2:
        raise ValueError(f"glu needs an even channel count, got {nc}")
    a, b = x.split(nc // 2, dim=dim)
    return a * torch.sigmoid(b)


class GLU(nn.Module):
    """GLU over the channel axis of an NCHW tensor."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return glu(x, dim=1)


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 upsample of an NHWC tensor."""
    return nhwc(F.interpolate(nchw(x), scale_factor=2, mode="nearest"))


def conv3x3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, bias=False)


def batch_norm(ch: int) -> nn.BatchNorm2d:
    """BatchNorm with torch's defaults (eps 1e-5); the port runs it in eval."""
    return nn.BatchNorm2d(ch, eps=BN_EPS)


class UpBlock(nn.Sequential):
    """nearest x2 -> conv3x3(in -> 2*out) -> BN -> GLU (= util.py:74-80)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(nn.Upsample(scale_factor=2, mode="nearest"),
                         conv3x3(cin, cout * 2), batch_norm(cout * 2), GLU())

    @property
    def conv(self) -> nn.Conv2d:
        return self[1]

    @property
    def bn(self) -> nn.BatchNorm2d:
        return self[2]


class ResBlock(nn.Module):
    """conv3x3(c->2c) -> BN -> GLU -> conv3x3(c->c) -> BN, + identity
    (= util.py:110-130)."""

    def __init__(self, ch: int):
        super().__init__()
        self.block = nn.Sequential(conv3x3(ch, ch * 2), batch_norm(ch * 2),
                                   GLU(), conv3x3(ch, ch), batch_norm(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x) + x


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view (channels_last memory when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> contiguous NHWC (no copy for a channels_last tensor)."""
    return x.permute(0, 2, 3, 1).contiguous()


def depth_to_space(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """Pixel shuffle of an NHWC tensor in torch's pixel order: channel
    b1 * bs * C' + b2 * C' + c' goes to pixel offset (b1, b2), channel c'."""
    n, h, w, c = x.shape
    bs = block_size
    x = x.reshape(n, h, w, bs, bs, c // (bs * bs)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * bs, w * bs, c // (bs * bs))


def space_to_depth(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """Inverse of `depth_to_space`."""
    n, h, w, c = x.shape
    bs = block_size
    x = x.reshape(n, h // bs, bs, w // bs, bs, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // bs, w // bs, bs * bs * c)


def conv_hwio(conv: nn.Conv2d) -> torch.Tensor:
    """A conv's OIHW weight as a contiguous HWIO tensor (the kernels' layout)."""
    return conv.weight.permute(2, 3, 1, 0).contiguous()

