"""Generator stage variants (counterpart of tgsr_tpu/models/variants.py; =
util.py:133-171, 404-722, 827-890, 937-1061): the reference's alternative
and experimental stages, which no entry point builds. Library modules, held
against the JAX package's on the CPU.

NCHW inside, words [B, T, E], as the port's other generator modules. The
reference ships no weights for these, and JAX no converter: the modules
carry the JAX package's flax names (`im2f_conv`, `residual_0`, `fout`, ...;
the fc stem's auto-name `_FcEntry_0` under `flax_names`), so
`checkpoints/from_jax.library_state_dict` carries a JAX tree across and
`library_variables` back. Where JAX uses `WordPixelAttention`, so does the
port: on a CUDA tensor it launches row 1's kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tgsr_tpu_torch.ops.attention import WordPixelAttention, WordPixelAttentionWeighted
from tgsr_tpu_torch.ops.blocks import (BatchNorm1d, Block3x3Relu, DownBlock, ResBlock, UpBlock,
                                       batch_norm, conv3x3, glu)

INSTANCE_NORM_EPS = 1e-5  # torch's InstanceNorm2d default


class _FcEntry(nn.Module):
    """Linear(nz -> ngf * 4 * 4 * 2, no bias) -> BN1d -> GLU -> a 4 x 4 grid
    (util.py:413-417). The grid is channel-major, torch's view(-1, ngf, 4,
    4) (util.py:433): a [B, 4, 4, ngf] reshape would scramble the fc
    features across space and channels (JAX's trap, variants.py:42-46)."""

    def __init__(self, ngf: int, nz: int):
        super().__init__()
        self.ngf = ngf
        self.fc = nn.Linear(nz, ngf * 4 * 4 * 2, bias=False)
        self.fc_bn = BatchNorm1d(ngf * 4 * 4 * 2, eps=1e-5)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return glu(self.fc_bn(self.fc(z))).reshape(-1, self.ngf, 4, 4)


class _FcStem(nn.Module):
    """A module that opens with `_FcEntry` and a chain of `upsample{i}`
    UpBlocks, flax's auto-name of the stem kept in `flax_names`."""

    flax_names = {"fc_entry": "_FcEntry_0"}

    def _up_chain(self, widths):
        for i, (cin, cout) in enumerate(zip(widths, widths[1:]), 1):
            self.add_module(f"upsample{i}", UpBlock(cin, cout))
        self.n_up = len(widths) - 1

    def _stem(self, code: torch.Tensor) -> torch.Tensor:
        out = self.fc_entry(code)
        for i in range(1, self.n_up + 1):
            out = getattr(self, f"upsample{i}")(out)
        return out


class InitStageG(_FcStem):
    """= INIT_STAGE_G (util.py:404-443), AttnGAN's entry: [c_code, z_code]
    -> fc 4 x 4 -> four UpBlocks -> 64 x 64 at ngf / 16 channels."""

    def __init__(self, ngf: int, nz: int):
        super().__init__()
        self.fc_entry = _FcEntry(ngf, nz)
        self._up_chain([ngf, ngf // 2, ngf // 4, ngf // 8, ngf // 16])

    def forward(self, z_code: torch.Tensor, c_code: torch.Tensor) -> torch.Tensor:
        return self._stem(torch.cat([c_code, z_code], dim=-1))


class InitStageGup4(_FcStem):
    """= INIT_STAGE_Gup4 (util.py:447-475): fc 4 x 4 -> two UpBlocks -> 16 x 16."""

    def __init__(self, ngf: int, nz: int):
        super().__init__()
        self.fc_entry = _FcEntry(ngf, nz)
        self._up_chain([ngf, ngf // 2, ngf // 4])

    def forward(self, z_code: torch.Tensor, c_code: torch.Tensor) -> torch.Tensor:
        return self._stem(torch.cat([c_code, z_code], dim=-1))


class InitStageGim(_FcStem):
    """= INIT_STAGE_Gim (util.py:479-561, define_module0): the LR image
    (`fin`) beside the sentence code brought to the LR size (fc 4 x 4 and
    two or, at scale 8, three UpBlocks), fused by `fout`."""

    def __init__(self, ngf: int = 32, scale: int = 8, c_dim: int = 100, in_ch: int = 3):
        super().__init__()
        self.fin = Block3x3Relu(in_ch, ngf)
        self.fc_entry = _FcEntry(ngf, c_dim)
        self._up_chain([ngf] * (4 if scale == 8 else 3))
        self.fout = Block3x3Relu(ngf * 2, ngf)

    def forward(self, lr_img: torch.Tensor, c_code: torch.Tensor) -> torch.Tensor:
        return self.fout(torch.cat([self._stem(c_code), self.fin(lr_img)], dim=1))


class InitStageGf(_FcStem):
    """= INIT_STAGE_Gf (util.py:565-613): as `InitStageGim` on precomputed LR
    features of `feat_ch` channels; `fout` gives 32 channels."""

    def __init__(self, ngf: int = 32, scale: int = 8, c_dim: int = 100, feat_ch: int = 32):
        super().__init__()
        self.fc_entry = _FcEntry(ngf, c_dim)
        widths = [ngf, ngf // 2, ngf // 4] + ([ngf // 8] if scale == 8 else [])
        self._up_chain(widths)
        self.fout = Block3x3Relu(widths[-1] + feat_ch, 32)

    def forward(self, lr_features: torch.Tensor, c_code: torch.Tensor) -> torch.Tensor:
        return self.fout(torch.cat([self._stem(c_code), lr_features], dim=1))


class InitStageGfc(_FcStem):
    """= INIT_STAGE_Gfc (util.py:617-659): the sentence code alone, fc 4 x 4
    and three UpBlocks (32 x 32; at scale 1 three more, 256 x 256)."""

    def __init__(self, ngf: int = 32, scale: int = 8, c_dim: int = 100):
        super().__init__()
        self.fc_entry = _FcEntry(ngf, c_dim)
        self._up_chain([ngf, ngf // 2, ngf // 4, ngf // 8]
                       + ([ngf // 8] * 3 if scale == 1 else []))

    def forward(self, c_code: torch.Tensor) -> torch.Tensor:
        return self._stem(c_code)


class InitStageGImg(nn.Module):
    """= INIT_STAGE_GImg (util.py:663-722): image features and word attention
    at the LR size, no upsample; `weightatten` takes the reweighted attention
    (GlobalAttentionGeneral_weight)."""

    def __init__(self, ngf: int = 32, r_num: int = 2, weightatten: bool = False,
                 cdf: int = 256, in_ch: int = 3):
        super().__init__()
        self.r_num = r_num
        self.im2f_conv = conv3x3(in_ch, ngf * 2)
        self.im2f_bn = batch_norm(ngf * 2)
        self.att = (WordPixelAttentionWeighted if weightatten else WordPixelAttention)(ngf, cdf)
        for i in range(r_num):
            self.add_module(f"residual_{i}", ResBlock(ngf * 2))
        self.fout = Block3x3Relu(ngf * 2, ngf)

    def forward(self, lr_img: torch.Tensor, words: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        h_code = glu(self.im2f_bn(self.im2f_conv(lr_img)), dim=1)
        c_code, _ = self.att(h_code, words, mask)
        h = torch.cat([h_code, c_code], dim=1)
        for i in range(self.r_num):
            h = getattr(self, f"residual_{i}")(h)
        return self.fout(h)


class NextStageGNoAttn(nn.Module):
    """= NEXT_STAGE_G_noAttn (util.py:827-856): a conv-GLU in place of the
    attention, then ResBlocks and an UpBlock."""

    def __init__(self, ngf: int = 32, r_num: int = 2, in_ch: int = 32):
        super().__init__()
        self.r_num = r_num
        self.noatt = Block3x3Relu(in_ch, ngf)
        for i in range(r_num):
            self.add_module(f"residual_{i}", ResBlock(ngf))
        self.upsample = UpBlock(ngf, ngf)

    def forward(self, h_code: torch.Tensor) -> torch.Tensor:
        h = self.noatt(h_code)
        for i in range(self.r_num):
            h = getattr(self, f"residual_{i}")(h)
        return self.upsample(h)


def instance_norm(x: torch.Tensor, eps: float = INSTANCE_NORM_EPS) -> torch.Tensor:
    """Non-affine InstanceNorm2d over NCHW: per sample and channel, the
    biased variance, eps 1e-5 (torch's default, JAX's variants.py:245-248)."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


class NextStageGLR(nn.Module):
    """= NEXT_STAGE_G_LR (util.py:860-890): an attention stage without the
    upsample, InstanceNorm in its output fuse. Returns (features, attention
    maps [B, T, H, W])."""

    def __init__(self, ngf: int = 32, r_num: int = 2, cdf: int = 256):
        super().__init__()
        self.r_num = r_num
        self.att = WordPixelAttention(ngf, cdf)
        for i in range(r_num):
            self.add_module(f"residual_{i}", ResBlock(ngf * 2))
        self.fout_conv = conv3x3(ngf * 2, ngf * 2)

    def forward(self, h_code: torch.Tensor, words: torch.Tensor,
                mask: Optional[torch.Tensor]):
        c_code, att = self.att(h_code, words, mask, need_attn=True)
        h = torch.cat([h_code, c_code], dim=1)
        for i in range(self.r_num):
            h = getattr(self, f"residual_{i}")(h)
        return glu(instance_norm(self.fout_conv(h)), dim=1), att


class EDCoder(nn.Module):
    """= EDCODER (util.py:133-171): a small U-Net, three DownBlocks and three
    UpBlocks with skip concatenations, then a tanh image head."""

    def __init__(self, ngf: int = 32, in_ch: int = 3):
        super().__init__()
        self.conv1 = Block3x3Relu(in_ch, ngf)
        self.d1 = DownBlock(ngf, ngf * 2)
        self.d2 = DownBlock(ngf * 2, ngf * 4)
        self.d3 = DownBlock(ngf * 4, ngf * 8)
        self.u1 = UpBlock(ngf * 8, ngf * 4)
        self.conv2 = Block3x3Relu(ngf * 8, ngf * 4)
        self.u2 = UpBlock(ngf * 4, ngf * 2)
        self.conv3 = Block3x3Relu(ngf * 4, ngf * 2)
        self.u3 = UpBlock(ngf * 2, ngf)
        self.img_conv = conv3x3(ngf, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xd1 = self.d1(self.conv1(x))
        xd2 = self.d2(xd1)
        x23 = self.conv2(torch.cat([xd2, self.u1(self.d3(xd2))], dim=1))
        x13 = self.conv3(torch.cat([xd1, self.u2(x23)], dim=1))
        return torch.tanh(self.img_conv(self.u3(x13)))


# -- the Image-Adaptive Word Demand family (util.py:937-1061) -----------------

def _pixels(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> [B, H*W, C], pixels in row-major order (JAX's NHWC reshape)."""
    return x.flatten(2).transpose(1, 2)


def _channel_correlation(conv1: nn.Conv2d, conv2: nn.Conv2d, imf: torch.Tensor) -> torch.Tensor:
    """softmax over axis 1 of [B, E, E] = sum over pixels of conv1 x conv2."""
    w = torch.einsum("bpe,bpf->bef", _pixels(conv1(imf)), _pixels(conv2(imf)))
    return torch.softmax(w, dim=1)


def _pooled_pixel_correlation(conv1: nn.Conv2d, conv2: nn.Conv2d,
                              imf: torch.Tensor) -> torch.Tensor:
    """The [B, q, q] pixel-pair correlation of two one-channel convs
    (softmax over axis 1), AvgPool2d(5, stride 4, padding 2) with the padding
    counted -> [B, q / 4, q / 4]."""
    b = imf.shape[0]
    h1 = conv1(imf).reshape(b, 1, -1)
    h2 = conv2(imf).reshape(b, 1, -1)
    h4 = torch.softmax(torch.einsum("bxq,bxp->bqp", h2, h1), dim=1)
    return F.avg_pool2d(h4[:, None], 5, stride=4, padding=2, count_include_pad=True)[:, 0]


class IAWD(nn.Module):
    """= IAWD (util.py:937-960): words reweighted by the image's channel
    correlation, plus the words. imf NCHW, words [B, T, E]."""

    def __init__(self, out_features: int = 256, in_ch: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_features, 3, padding=1, bias=False)
        self.conv2 = nn.Conv2d(in_ch, out_features, 3, padding=1, bias=False)

    def forward(self, imf: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
        w = _channel_correlation(self.conv1, self.conv2, imf)
        return torch.einsum("bef,btf->bte", w, words) + words


class WordAtten(nn.Module):
    """= Word_atten (util.py:963-987): a scalar weight per word. The
    reference's Softmax(dim=1) normalises the feature axis (util.py:984), so
    the weight is 1 / out_features for every word, as in JAX (kept)."""

    def __init__(self, out_features: int = 256, in_ch: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_features, 3, padding=1, bias=False)
        self.conv2 = nn.Conv2d(in_ch, out_features, 3, padding=1, bias=False)

    def forward(self, imf: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
        w = _channel_correlation(self.conv1, self.conv2, imf)
        iawf = torch.softmax(torch.einsum("bef,btf->bte", w, words), dim=2)
        return iawf.mean(dim=-1, keepdim=True) * words


class IAWDSent(nn.Module):
    """= IAWDsent (util.py:990-1016): the pooled pixel-pair correlation
    applied to the sentence vector [B, E], E = q / 4 (the reference's
    contract)."""

    def __init__(self, in_ch: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, 1, 3, padding=1, bias=False)
        self.conv2 = nn.Conv2d(in_ch, 1, 3, padding=1, bias=False)

    def forward(self, imf: torch.Tensor, sent: torch.Tensor) -> torch.Tensor:
        w = _pooled_pixel_correlation(self.conv1, self.conv2, imf)
        v = sent[:, :, None]
        return (w @ v + v)[..., 0]


class IAWDWord(nn.Module):
    """= IAWDword (util.py:1019-1043): the same correlation applied to a word
    matrix wf whose leading feature axis is q / 4."""

    def __init__(self, in_ch: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, 1, 3, padding=1, bias=False)
        self.conv2 = nn.Conv2d(in_ch, 1, 3, padding=1, bias=False)

    def forward(self, imf: torch.Tensor, wf: torch.Tensor) -> torch.Tensor:
        return _pooled_pixel_correlation(self.conv1, self.conv2, imf) @ wf + wf


class IAWDSpatial(nn.Module):
    """= IAWDspatial (util.py:1046-1061), as JAX implements its evident
    intent (the reference calls an undefined self.sm): words scaled by one
    plus the mean of the spatial softmax of the channel sums."""

    def forward(self, imf: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
        b, _, ih, iw = imf.shape
        w = torch.softmax(imf.sum(dim=1).reshape(b, -1), dim=-1).reshape(b, ih, iw)
        return words * (1.0 + w.mean(dim=(1, 2))[:, None, None])
