"""Low-frequency text-attentive SR generator (counterpart of
tgsr_tpu/models/generator.py; = CA_NET, INIT_STAGE_GImgup, NEXT_STAGE_G,
GET_IMAGE_G_noAct and G_SR_NET_low, util.py / model.py:34-78, and the
ablation G_SR_NET_low_stage1, model.py:81-130, EVAL.STAGE1).

NCHW inside; module names are the reference's state-dict keys. The last
stage's upsample feeds only its image head, so the float32 and bfloat16
serving paths run it as one fused up-head site (`ops/up_head.py`
`up_head_site` in float32, `ops/up_head_packed.py` `up_head_packed_site` in
bfloat16) and its 2x features never reach device memory. Without a site
(int8 serving, whose UpBlock and head are quantized modules; calibration)
the stage runs its modules one after another.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tgsr_tpu_torch.ops.attention import WordPixelAttention
from tgsr_tpu_torch.ops.blocks import (GLU, LEAKY_SLOPE, ResBlock, UpBlock, UpBlockNoBN,
                                       batch_norm, conv3x3, glu)
from tgsr_tpu_torch.ops.up_head import UpHeadWeights, fold_up_head
from tgsr_tpu_torch.utils.remat import remat


class CANet(nn.Module):
    """Conditioning augmentation (= CA_NET, util.py:372-400): Linear
    t_dim -> 4*c_dim -> GLU -> (mu, logvar). JAX's CANet also draws c_code =
    eps * exp(logvar / 2) + mu (tgsr_tpu/models/generator.py:37-57), which
    nothing on the SR path reads, in training as in serving: only mu and
    logvar reach the KL loss. So the port draws nothing (a deliberate
    difference, ROADMAP Queue C) and returns mu and logvar."""

    def __init__(self, t_dim: int, c_dim: int):
        super().__init__()
        self.fc = nn.Linear(t_dim, c_dim * 4)
        self.c_dim = c_dim

    def forward(self, sent: torch.Tensor):
        x = glu(self.fc(sent), dim=-1)
        return x[:, :self.c_dim], x[:, self.c_dim:]


class NextStageG(nn.Module):
    """= NEXT_STAGE_G (util.py:781-823): attend, concat, R_NUM ResBlocks on
    2*ngf, then an UpBlock to ngf; without BN (`use_bn` False, stage 1's
    first stage) the ResBlocks and the UpBlock have none."""

    def __init__(self, ngf: int, cdf: int, r_num: int, use_bn: bool = True):
        super().__init__()
        self.att = WordPixelAttention(ngf, cdf)
        self.residual = nn.Sequential(*[ResBlock(ngf * 2, use_bn) for _ in range(r_num)])
        self.upsample = UpBlock(ngf * 2, ngf) if use_bn else UpBlockNoBN(ngf * 2, ngf)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def features(self, x, words, mask, need_attn: bool = False):
        """Everything before `upsample`: (features [B, 2ngf, h, w], attn)."""
        h_code = self.embed(x)
        c_code, attn = self.att(h_code, words, mask, need_attn)
        return self.residual(torch.cat([h_code, c_code], dim=1)), attn

    def forward(self, x, words, mask, need_attn: bool = False):
        h, attn = self.features(x, words, mask, need_attn)
        return self.upsample(h), attn


class InitStageGImgUp(NextStageG):
    """= INIT_STAGE_GImgup (util.py:726-777): `im2f` embeds the LR image to
    ngf channels, then as NextStageG; `use_bn` False drops every BN
    (im2f is then Sequential(conv3x3, GLU))."""

    def __init__(self, ngf: int, cdf: int, r_num: int, use_bn: bool = True):
        super().__init__(ngf, cdf, r_num, use_bn)
        self.im2f = (nn.Sequential(conv3x3(3, ngf * 2), batch_norm(ngf * 2), GLU()) if use_bn
                     else nn.Sequential(conv3x3(3, ngf * 2), GLU()))

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        return self.im2f(x)


class GetImageG(nn.Module):
    """conv3x3(ngf -> 3), then tanh where `use_tanh` (= GET_IMAGE_G, the x16
    family's heads, models16.py) or no activation (= GET_IMAGE_G_noAct, the
    x8 family's, model.py). The Tanh holds no weights, so both keep the
    reference's one key, `img.0.weight`."""

    def __init__(self, ngf: int, use_tanh: bool = False):
        super().__init__()
        self.use_tanh = use_tanh
        self.img = nn.Sequential(conv3x3(ngf, 3), *([nn.Tanh()] if use_tanh else []))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.img(h)


class GSRNetLow(nn.Module):
    """= G_SR_NET_low (model.py:34-78) with n_stages stages (3 for x8).

    forward(lr NCHW, sent [B, cdf], words [B, T, cdf], mask [B, T]) ->
    (pyramid of NCHW images, attention maps [B, T, H, W] (empty unless
    need_attn), mu, logvar). `up_head` is the last stage's site function,
    `site(features, use_tanh=) -> NCHW image`, made once by the caller from
    `up_head_weights()`; without it the last stage runs `upsample`, then
    its head, as training does (train mode: every BN on batch statistics).
    `remat` (JAX's remat 'low', tgsr_tpu/models/generator.py:155-163): in
    train mode each stage call is rematerialised (`utils/remat.py`), so
    only the stage-boundary features are kept for the backward; CANet and
    the image heads run as they are."""

    tied = False  # one module under several stage names (the x16 family, models16.py)
    # UpBlock convs (JAX paths) whose output feeds only the image head
    head_only_upblocks = frozenset({"h_net3/upsample/conv"})
    has_up_head_site = True  # the last stage runs as one fused up-head site when served

    def __init__(self, ngf: int = 32, cdf: int = 256, c_dim: int = 100,
                 n_stages: int = 3, r_num: int = 2, remat: bool = False):
        super().__init__()
        self.n_stages = n_stages
        self.remat = remat
        self.ca_net = CANet(cdf, c_dim)
        self.h_net1 = InitStageGImgUp(ngf, cdf, r_num)
        for s in range(2, n_stages + 1):
            setattr(self, f"h_net{s}", NextStageG(ngf, cdf, r_num))
        for s in range(1, n_stages + 1):
            setattr(self, f"img_net{s}", GetImageG(ngf))

    def up_head_weights(self) -> UpHeadWeights:
        """The last stage's `upsample` + image head, folded for the kernel."""
        n = self.n_stages
        return fold_up_head(getattr(self, f"h_net{n}").upsample,
                            getattr(self, f"img_net{n}").img[0])

    def forward(self, lr, sent, words, mask: Optional[torch.Tensor],
                need_attn: bool = False,
                up_head: Optional[Callable[..., torch.Tensor]] = None):
        mu, logvar = self.ca_net(sent)
        fake_imgs: List[torch.Tensor] = []
        att_maps: List[torch.Tensor] = []
        h = lr
        for s in range(1, self.n_stages + 1):
            stage = getattr(self, f"h_net{s}")
            head = getattr(self, f"img_net{s}")
            if s < self.n_stages or up_head is None:
                args = (h, words, mask, need_attn)
                h, att = remat(stage, *args) if self.remat and self.training else stage(*args)
                fake_imgs.append(head(h))
            else:
                feats, att = stage.features(h, words, mask, need_attn)
                fake_imgs.append(up_head(feats, use_tanh=head.use_tanh))
            if need_attn:
                att_maps.append(att)
        return fake_imgs, att_maps, mu, logvar


class GSRNetLowStage1(nn.Module):
    """= G_SR_NET_low_stage1 (model.py:81-130; JAX's GSRNetLowStage1,
    tgsr_tpu/models/generator.py:188-230), the EVAL.STAGE1 ablation: word
    attention at the first stage only, no BN anywhere. h_net1 is
    INIT_STAGE_GImgup without BN; then the shared `up1` (conv3x3(ngf ->
    2ngf) -> LeakyReLU(0.2) -> upBlocknoBN(2ngf -> ngf)) and a plain no-BN
    ResBlock, twice (h_net2, h_net3); every image head has a tanh. The
    reference calls `up1` for both steps (model.py:116, :123): it is one
    module called twice, and the declared `up2` never runs, so its keys in a
    reference `.pth` are dead weights (`checkpoints.reference` drops them,
    as JAX's convert_netg_low_stage1 does). The attention maps of stages 2
    and 3 are the first stage's, nearest-upsampled.

    Same call as GSRNetLow. No upsample of it feeds an image head alone, so
    it has no fused up-head site (`up_head` must be None): served in float32
    or bfloat16, it launches the attention once a forward and its netGH the
    one up-head site."""

    tied = False
    head_only_upblocks = frozenset()
    has_up_head_site = False

    def __init__(self, ngf: int = 32, cdf: int = 256, c_dim: int = 100, r_num: int = 2):
        super().__init__()
        self.n_stages = 3
        self.ca_net = CANet(cdf, c_dim)
        self.h_net1 = InitStageGImgUp(ngf, cdf, r_num, use_bn=False)
        self.up1 = nn.Sequential(conv3x3(ngf, ngf * 2), nn.LeakyReLU(LEAKY_SLOPE),
                                 UpBlockNoBN(ngf * 2, ngf))
        self.h_net2 = ResBlock(ngf, use_bn=False)
        self.h_net3 = ResBlock(ngf, use_bn=False)
        for s in range(1, 4):
            setattr(self, f"img_net{s}", GetImageG(ngf, use_tanh=True))

    def forward(self, lr, sent, words, mask: Optional[torch.Tensor],
                need_attn: bool = False,
                up_head: Optional[Callable[..., torch.Tensor]] = None):
        if up_head is not None:
            raise ValueError("GSRNetLowStage1 has no fused up-head site")
        mu, logvar = self.ca_net(sent)
        h1, att = self.h_net1(lr, words, mask, need_attn)
        h2 = self.h_net2(self.up1(h1))
        h3 = self.h_net3(self.up1(h2))
        fake_imgs = [self.img_net1(h1), self.img_net2(h2), self.img_net3(h3)]
        att_maps: List[torch.Tensor] = []
        if need_attn:
            att_maps = [att, F.interpolate(att, scale_factor=2, mode="nearest"),
                        F.interpolate(att, scale_factor=4, mode="nearest")]
        return fake_imgs, att_maps, mu, logvar
