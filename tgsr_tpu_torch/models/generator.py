"""Low-frequency text-attentive SR generator (counterpart of
tgsr_tpu/models/generator.py; = CA_NET, INIT_STAGE_GImgup, NEXT_STAGE_G,
GET_IMAGE_G_noAct and G_SR_NET_low, util.py / model.py:34-78).

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
from torch import nn

from tgsr_tpu_torch.ops.attention import WordPixelAttention
from tgsr_tpu_torch.ops.blocks import GLU, ResBlock, UpBlock, batch_norm, conv3x3, glu
from tgsr_tpu_torch.ops.up_head import UpHeadWeights, fold_up_head


class CANet(nn.Module):
    """Conditioning augmentation (= CA_NET, util.py:372-400): Linear
    t_dim -> 4*c_dim -> GLU -> (mu, logvar). Its sampled code is unused by
    the SR path, so eval returns only mu and logvar."""

    def __init__(self, t_dim: int, c_dim: int):
        super().__init__()
        self.fc = nn.Linear(t_dim, c_dim * 4)
        self.c_dim = c_dim

    def forward(self, sent: torch.Tensor):
        x = glu(self.fc(sent), dim=-1)
        return x[:, :self.c_dim], x[:, self.c_dim:]


class NextStageG(nn.Module):
    """= NEXT_STAGE_G (util.py:781-823): attend, concat, R_NUM ResBlocks on
    2*ngf, then an UpBlock to ngf."""

    def __init__(self, ngf: int, cdf: int, r_num: int):
        super().__init__()
        self.att = WordPixelAttention(ngf, cdf)
        self.residual = nn.Sequential(*[ResBlock(ngf * 2) for _ in range(r_num)])
        self.upsample = UpBlock(ngf * 2, ngf)

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
    ngf channels, then as NextStageG."""

    def __init__(self, ngf: int, cdf: int, r_num: int):
        super().__init__(ngf, cdf, r_num)
        self.im2f = nn.Sequential(conv3x3(3, ngf * 2), batch_norm(ngf * 2), GLU())

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        return self.im2f(x)


class GetImageG(nn.Module):
    """conv3x3(ngf -> 3), no activation (= GET_IMAGE_G_noAct)."""

    def __init__(self, ngf: int):
        super().__init__()
        self.img = nn.Sequential(conv3x3(ngf, 3))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.img(h)


class GSRNetLow(nn.Module):
    """= G_SR_NET_low (model.py:34-78) with n_stages stages (3 for x8).

    forward(lr NCHW, sent [B, cdf], words [B, T, cdf], mask [B, T]) ->
    (pyramid of NCHW images, attention maps [B, T, H, W] (empty unless
    need_attn), mu, logvar). `up_head` is the last stage's site function,
    `site(features) -> NCHW image`, made once by the caller from
    `up_head_weights()`; without it the last stage runs `upsample`, then
    its head."""

    def __init__(self, ngf: int = 32, cdf: int = 256, c_dim: int = 100,
                 n_stages: int = 3, r_num: int = 2):
        super().__init__()
        self.n_stages = n_stages
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
                h, att = stage(h, words, mask, need_attn)
                fake_imgs.append(head(h))
            else:
                feats, att = stage.features(h, words, mask, need_attn)
                fake_imgs.append(up_head(feats))
            if need_attn:
                att_maps.append(att)
        return fake_imgs, att_maps, mu, logvar
