"""DAMSM image encoders (counterpart of tgsr_tpu/models/image_encoder.py).

`CNNEncoder` = CNN_ENCODER (util.py:263-368): torchvision's Inception-v3
feature graph up to Mixed_7c, tapped at Mixed_6e (17 x 17 x 768, the region
features) and at the mean of Mixed_7c (2048, the global code), and two heads,
`emb_features` (a bias-free 1 x 1 conv 768 -> nef, the reference's
[nef, 768, 1, 1] weight) and `emb_cnn_code` (Linear 2048 -> nef). The input
is resized to 299 x 299 by `ops/image.resize` (the matrices of
`jax.image.resize`, bilinear). The backbone modules sit at the top level
under torchvision's names, so a reference `image_encoder<N>.pth` loads
with `strict=True`. `SimpleCNNEncoder` is the JAX package's small
fully-trainable encoder (resize to 137, three stride-2 convs, a 2 x 2 VALID
conv to 17 x 17), for DAMSM training without the Inception zoo weights.

Both take NHWC images in [-1, 1] and return (region features [B, 289, nef]
in (h, w) row-major order, code [B, nef]), as the JAX modules. BN is
`ops/blocks.BatchNorm` (flax's train mode, momentum 0.9), eps 0.001 in the
Inception graph and 1e-5 in SimpleCNN. CNNEncoder's backbone is always
frozen, as JAX's `freeze_backbone=True` (its default, the only value the
JAX trainers use): the resize and the backbone run without autograd, so
both backbone outputs are cut from the graph as JAX's `stop_gradient` cuts
them: nothing behind the heads gets a gradient, the input image included,
and no activation is kept for a backward (train-mode BN still moves its
running stats).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from tgsr_tpu_torch.ops.blocks import BatchNorm, nchw
from tgsr_tpu_torch.ops.image import resize

Pad = Union[int, Tuple[int, int]]
INCEPTION_SIZE = 299
SIMPLE_SIZE = 137


def avg_pool_3x3_same(x: torch.Tensor) -> torch.Tensor:
    """F.avg_pool2d(k 3, s 1, p 1), the padding counted (count_include_pad)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """F.max_pool2d(k 3, s 2), VALID."""
    return F.max_pool2d(x, 3, stride=2)


class BasicConv2d(nn.Module):
    """Conv (no bias) + BN (eps 0.001) + ReLU (torchvision's BasicConv2d)."""

    def __init__(self, cin: int, cout: int, kernel: Pad, stride: int = 1, padding: Pad = 0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = BatchNorm(cout, eps=0.001)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(avg_pool_3x3_same(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, max_pool_3x3_s2(x)], dim=1)


class InceptionC(nn.Module):
    """The 1 x 7 / 7 x 1 convs pad (0, 3) / (3, 0), as torchvision's."""

    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for m in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                  self.branch7x7dbl_5):
            bd = m(bd)
        bp = self.branch_pool(avg_pool_3x3_same(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for m in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = m(b7)
        return torch.cat([b3, b7, max_pool_3x3_s2(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        bp = self.branch_pool(avg_pool_3x3_same(x))
        return torch.cat([self.branch1x1(x), b3, bd, bp], dim=1)


class InceptionV3Backbone(nn.Module):
    """torchvision's inception_v3 feature graph up to Mixed_7c (no aux
    head, no fc). `features_and_pooled(x NCHW [B, 3, 299, 299])` ->
    (Mixed_6e [B, 768, 17, 17], the mean of Mixed_7c [B, 2048])."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)

    def features_and_pooled(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = max_pool_3x3_s2(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = max_pool_3x3_s2(x)
        for m in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b,
                  self.Mixed_6c, self.Mixed_6d, self.Mixed_6e):
            x = m(x)
        features = x  # [B, 768, 17, 17]
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        return features, x.mean(dim=(2, 3))  # F.avg_pool2d(k 8) -> [B, 2048]


def _regions(features: torch.Tensor) -> torch.Tensor:
    """[B, nef, 17, 17] -> [B, 289, nef] in (h, w) row-major order (JAX's
    reshape of NHWC)."""
    b, c = features.shape[:2]
    return features.permute(0, 2, 3, 1).reshape(b, -1, c)


class CNNEncoder(InceptionV3Backbone):
    """= CNN_ENCODER(nef): the Inception-v3 backbone and the two heads."""

    def __init__(self, nef: int = 256):
        super().__init__()
        self.nef = nef
        self.emb_features = nn.Conv2d(768, nef, 1, bias=False)
        self.emb_cnn_code = nn.Linear(2048, nef)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x NHWC [B, H, W, 3] in [-1, 1] -> (features [B, 289, nef], code
        [B, nef]), the backbone frozen."""
        with torch.no_grad():
            x = resize(x, (INCEPTION_SIZE, INCEPTION_SIZE), "bilinear")  # util.py:311
            features, pooled = self.features_and_pooled(nchw(x))
        return _regions(self.emb_features(features)), self.emb_cnn_code(pooled)


class SimpleCNNEncoder(nn.Module):
    """The JAX package's small fully-trainable DAMSM image encoder: the same
    interface as CNNEncoder (17 x 17 regions, a global code)."""

    def __init__(self, nef: int = 256, width: int = 64):
        super().__init__()
        self.nef = nef
        chans = (3, width, width * 2, width * 4)
        # flax's SAME at stride 2 pads (1, 1) on 137, 69 and 35 px
        for i in range(3):
            setattr(self, f"conv{i}", nn.Conv2d(chans[i], chans[i + 1], 3, stride=2, padding=1,
                                                bias=False))
            setattr(self, f"bn{i}", BatchNorm(chans[i + 1], eps=1e-5))
        self.conv_17 = nn.Conv2d(width * 4, width * 8, 2, bias=False)  # 18 -> 17, VALID
        self.emb_features = nn.Conv2d(width * 8, nef, 1, bias=False)
        self.emb_cnn_code = nn.Linear(width * 8, nef)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = nchw(resize(x, (SIMPLE_SIZE, SIMPLE_SIZE), "bilinear"))
        for i in range(3):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        x = F.relu(self.conv_17(x))  # [B, 8w, 17, 17]
        return _regions(self.emb_features(x)), self.emb_cnn_code(x.mean(dim=(2, 3)))


def make_image_encoder(simple: bool, nef: int = 256) -> nn.Module:
    """The encoder of one family: SimpleCNNEncoder or CNNEncoder."""
    return SimpleCNNEncoder(nef) if simple else CNNEncoder(nef)

