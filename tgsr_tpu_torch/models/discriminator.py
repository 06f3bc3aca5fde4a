"""Multi-scale conditional discriminators (counterpart of
tgsr_tpu/models/discriminator.py `DNet`, :51-133).

The reference ships no D class (its losses call `netD(imgs)`,
`netD.COND_DNET(features, sent_emb)` and `netD.UNCOND_DNET(features)`); the
JAX package builds the AttnGAN convention those calls pin down, and this is
that network in PyTorch, NCHW, with the JAX tree's names as module names
(`downs.0.conv` for `downs_0/conv`; `dnet_state_dict` in
`checkpoints/from_jax.py` carries a tree across). Outputs are logits.
`ESRGANDNet`, the ESRGAN / relativistic family's plain D, carries JAX's flax
names as they are (`down_0`, `fc1`; `from_jax.library_state_dict`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tgsr_tpu_torch.ops.blocks import batch_norm

LEAK = 0.2


def _logit_input(x: torch.Tensor) -> torch.Tensor:
    """The input of a 4x4, stride-4 logit conv, in NCHW order on the CPU. The
    features reach it channels_last (the image comes NHWC), and PyTorch's
    CPU bfloat16 convolution (oneDNN; torch 2.13 on a Xeon with AMX) sums a
    channels_last input of 16 or 24 channels under that kernel wrongly, by
    7-37 % of the terms' absolute sum (a 16 px DNet at ndf 8, an 8 px one at
    ndf 16). The card's cuDNN takes it as it comes."""
    return x.contiguous() if x.device.type == "cpu" else x


class _Down(nn.Module):
    """conv4x4 stride 2 pad 1 [-> BN] -> LeakyReLU(0.2)."""

    def __init__(self, cin: int, cout: int, use_bn: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 4, stride=2, padding=1, bias=False)
        self.bn = batch_norm(cout) if use_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.leaky_relu(x, LEAK)


class _Block3x3LeakyRelu(nn.Module):
    """conv3x3 -> BN -> LeakyReLU(0.2)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1, bias=False)
        self.bn = batch_norm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.bn(self.conv(x)), LEAK)


class DNet(nn.Module):
    """The discriminator of one pyramid scale, `img_size` a power of two of
    at least 32: `features` downsamples to a [B, 8 ndf, 4, 4] cube (the
    channel ramp ndf -> 2 ndf -> 4 ndf -> 8 ndf, truncated below 64 px; above
    64 px a `_Down` + `_Block3x3LeakyRelu` pair per doubling);
    `cond_logit` joins the sentence, broadcast to 4 x 4, and `uncond_logit`
    reads the cube alone. `b_condition=False` builds no conditional head."""

    def __init__(self, ndf: int = 64, nef: int = 256, img_size: int = 64,
                 b_condition: bool = True):
        super().__init__()
        self.b_condition = b_condition
        downs = [_Down(3, ndf, use_bn=False)]
        size, mult = img_size // 2, 1
        while size > 4 and mult < 8:
            downs.append(_Down(ndf * mult, ndf * mult * 2))
            mult *= 2
            size //= 2
        extra = []
        while size > 4:
            extra.append(_Down(ndf * mult, ndf * mult * 2))
            extra.append(_Block3x3LeakyRelu(ndf * mult * 2, ndf * mult))
            size //= 2
        self.downs = nn.ModuleList(downs)
        self.extra = nn.ModuleList(extra)
        if b_condition:
            self.joint = _Block3x3LeakyRelu(ndf * mult + nef, ndf * 8)
            self.cond_out = nn.Conv2d(ndf * 8, 1, 4, stride=4)
        self.uncond_out = nn.Conv2d(ndf * mult, 1, 4, stride=4)

    def features(self, img: torch.Tensor) -> torch.Tensor:
        """img [B, 3, S, S] -> [B, 8 ndf, 4, 4] (fewer channels below 64 px)."""
        x = img
        for d in (*self.downs, *self.extra):
            x = d(x)
        return x

    def cond_logit(self, h: torch.Tensor, sent: torch.Tensor) -> torch.Tensor:
        """COND_DNET(features, sent_emb) -> [B] logits."""
        if not self.b_condition:
            raise ValueError("DNet(b_condition=False) has no conditional head "
                             "(reference bcondition semantics)")
        b = h.shape[0]
        c = sent[:, :, None, None].expand(b, sent.shape[1], 4, 4)
        x = self.joint(torch.cat([h, c.to(h.dtype)], dim=1))
        return self.cond_out(_logit_input(x)).reshape(b)

    def uncond_logit(self, h: torch.Tensor) -> torch.Tensor:
        """UNCOND_DNET(features) -> [B] logits."""
        return self.uncond_out(_logit_input(h)).reshape(h.shape[0])

    def forward(self, img: torch.Tensor, sent: torch.Tensor):
        """(cond logit or None, uncond logit), as the JAX DNet's __call__."""
        h = self.features(img)
        return (self.cond_logit(h, sent) if self.b_condition else None,
                self.uncond_logit(h))


class ESRGANDNet(nn.Module):
    """The plain unconditional SR discriminator of the ESRGAN / relativistic
    loss family (losses.py:813-883; JAX's ESRGANDNet,
    tgsr_tpu/models/discriminator.py:136-151): four `_Down`s (ndf, 2, 4, 8
    ndf; BN from the second), the spatial mean, Dense 100, LeakyReLU(0.2),
    Dense 1. img [B, 3, S, S] -> [B] logits."""

    def __init__(self, ndf: int = 64):
        super().__init__()
        widths = [3, ndf, ndf * 2, ndf * 4, ndf * 8]
        for i in range(4):
            self.add_module(f"down_{i}", _Down(widths[i], widths[i + 1], use_bn=i > 0))
        self.fc1 = nn.Linear(ndf * 8, 100)
        self.fc2 = nn.Linear(100, 1)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = img
        for i in range(4):
            x = getattr(self, f"down_{i}")(x)
        x = F.leaky_relu(self.fc1(x.mean(dim=(2, 3))), LEAK)
        return self.fc2(x).reshape(-1)
