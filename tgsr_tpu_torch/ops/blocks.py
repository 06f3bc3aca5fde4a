"""Conv blocks of the generators (counterpart of tgsr_tpu/ops/blocks.py).

Modules run NCHW (channels_last memory on the card) and carry the
reference's Sequential layouts, so their state-dict keys are the reference
checkpoint's: an UpBlock is Sequential(Upsample, conv3x3, BN, GLU) with keys
`1.weight` and `2.*`; a ResBlock keeps its Sequential under `block.{0,1,3,4}`;
without BN (the stage-1 generator's, util.py:83-88, :110-130) an UpBlockNoBN
is Sequential(Upsample, conv3x3, GLU), key `1.weight`, and a ResBlock's
Sequential holds `block.{0,2}`. The free functions keep the JAX package's
NHWC layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tgsr_tpu_torch.utils import remat

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


# the JAX package's leaky_relu slope (tgsr_tpu/ops/blocks.py:46), the
# reference's nn.LeakyReLU(0.2)
LEAKY_SLOPE = 0.2


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 upsample of an NHWC tensor."""
    return nhwc(F.interpolate(nchw(x), scale_factor=2, mode="nearest"))


def conv3x3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, bias=False)


class _FlaxTrainMode:
    """Flax's train-mode BatchNorm over every axis but the channel axis 1
    (`BatchNorm`'s docstring); eval mode is torch's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))  # at least float32, as flax
        dims = (0, *range(2, x.dim()))
        mean = xf.mean(dims)
        var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
        if not remat.recomputing():
            self._blend(mean, var)
        shape = (1, -1, *[1] * (x.dim() - 2))
        mul = torch.rsqrt(var + self.eps) * self.weight.to(xf.dtype)
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.to(xf.dtype).view(shape)
        return y.to(x.dtype)

    def _blend(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        with torch.no_grad():
            keep = 1.0 - self.momentum  # flax's momentum, 0.9
            self.running_mean.mul_(keep).add_(mean * (1.0 - keep))
            self.running_var.mul_(keep).add_(var * (1.0 - keep))
            self.num_batches_tracked.add_(1)


class BatchNorm(_FlaxTrainMode, nn.BatchNorm2d):
    """`nn.BatchNorm2d` (eps 1e-5, the reference's keys) whose train mode is
    flax's `BatchNorm` (the JAX package's `batch_norm(train=True)`,
    tgsr_tpu/ops/blocks.py:116-121), the one the port is held against:

    - batch moments in float32 (float64 for a float64 input), the variance
      as E[x^2] - E[x]^2 clipped at 0 (flax's fast variance), biased;
    - y = (x - mean) * (rsqrt(var + eps) * weight) + bias in that type, then
      in x's type;
    - running stats blended as 0.9 * old + 0.1 * batch with the *biased*
      variance. torch's own rule blends the unbiased one: a deliberate
      difference from the reference's torch (ROADMAP, Queue C);
    - not blended again in the backward's recompute of a rematerialised
      block (`utils/remat.recomputing()`), as flax's remat moves them once.
      The output reads the batch's moments only, never the running stats,
      so the recompute gives the forward's output whatever they hold.

    Eval mode is torch's, unchanged: every serving path runs it."""


class BatchNorm1d(_FlaxTrainMode, nn.BatchNorm1d):
    """`BatchNorm`'s rules over [B, C] features (flax's BatchNorm on a Dense
    output: the fc stem of models/variants.py)."""


def batch_norm(ch: int) -> BatchNorm:
    """BatchNorm with torch's defaults (eps 1e-5): eval in every serving
    path, flax's train mode in training (`BatchNorm`)."""
    return BatchNorm(ch, eps=BN_EPS)


class UpBlock(nn.Sequential):
    """nearest x2 -> conv3x3(in -> 2*out) -> BN -> GLU (= util.py:74-80)."""

    # the JAX module's names of the parameterised children
    # (`checkpoints/from_jax.flax_leaves`)
    flax_names = {"1": "conv", "2": "bn"}

    def __init__(self, cin: int, cout: int):
        super().__init__(nn.Upsample(scale_factor=2, mode="nearest"),
                         conv3x3(cin, cout * 2), batch_norm(cout * 2), GLU())

    @property
    def conv(self) -> nn.Conv2d:
        return self[1]

    @property
    def bn(self) -> nn.BatchNorm2d:
        return self[2]


class UpBlockNoBN(nn.Sequential):
    """nearest x2 -> conv3x3(in -> 2*out) -> GLU (= upBlocknoBN, util.py:83-88)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(nn.Upsample(scale_factor=2, mode="nearest"),
                         conv3x3(cin, cout * 2), GLU())

    @property
    def conv(self) -> nn.Conv2d:
        return self[1]

    bn = None


class ResBlock(nn.Module):
    """conv3x3(c->2c) -> [BN] -> GLU -> conv3x3(c->c) -> [BN], + identity
    (= util.py:110-130); without BN (`use_bn` False) the Sequential is
    (conv, GLU, conv)."""

    def __init__(self, ch: int, use_bn: bool = True):
        super().__init__()
        if use_bn:
            self.block = nn.Sequential(conv3x3(ch, ch * 2), batch_norm(ch * 2),
                                       GLU(), conv3x3(ch, ch), batch_norm(ch))
        else:
            self.block = nn.Sequential(conv3x3(ch, ch * 2), GLU(), conv3x3(ch, ch))

    # the JAX module's names of the BN layout's children (`flax_leaves`)
    flax_names = {"block.0": "conv1", "block.1": "bn1", "block.3": "conv2", "block.4": "bn2"}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x) + x


class DownBlock(nn.Sequential):
    """conv4x4 stride 2 pad 1 -> BN -> LeakyReLU(0.2) (= downBlock,
    util.py:92-98; JAX's DownBlock, tgsr_tpu/ops/blocks.py:187): keys `0.weight`
    and `1.*`, as the reference's Sequential."""

    flax_names = {"0": "conv", "1": "bn"}

    def __init__(self, cin: int, cout: int):
        super().__init__(nn.Conv2d(cin, cout, 4, stride=2, padding=1, bias=False),
                         batch_norm(cout), nn.LeakyReLU(LEAKY_SLOPE))


class Block3x3Relu(nn.Sequential):
    """conv3x3(in -> 2*out) -> BN -> GLU, spatial size kept (= Block3x3_relu,
    util.py:102-107; JAX's Block3x3Relu, tgsr_tpu/ops/blocks.py:201): keys
    `0.weight` and `1.*`."""

    flax_names = {"0": "conv", "1": "bn"}

    def __init__(self, cin: int, cout: int):
        super().__init__(conv3x3(cin, cout * 2), batch_norm(cout * 2), GLU())


class PlainResidualBlock(nn.Module):
    """conv3x3 -> [BN] -> LeakyReLU(0.2) -> conv3x3 -> [BN], + identity
    (= model.py:8-30 `_Residual_Block`; JAX's PlainResidualBlock,
    tgsr_tpu/ops/blocks.py:235), under JAX's names conv1, in1, conv2, in2."""

    def __init__(self, ch: int = 64, use_norm: bool = False):
        super().__init__()
        self.conv1 = conv3x3(ch, ch)
        self.in1 = batch_norm(ch) if use_norm else None
        self.conv2 = conv3x3(ch, ch)
        self.in2 = batch_norm(ch) if use_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(x)
        if self.in1 is not None:
            h = self.in1(h)
        h = self.conv2(F.leaky_relu(h, LEAKY_SLOPE))
        if self.in2 is not None:
            h = self.in2(h)
        return h + x


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

