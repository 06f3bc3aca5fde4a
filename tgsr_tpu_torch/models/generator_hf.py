"""High-frequency SRResNet branch (counterpart of
tgsr_tpu/models/generator_hf.py; = NetG_highweight, model.py:212-298), with
the LR image as input (INPUT_NETGH 'lr') and no weight map.

ims_s = conv_output(feat_s) + a * srb_s at 64, 128 and 256 px. The blend
weight `a` is not in the reference's state dict (model.py:246-248), so it is
a non-persistent buffer here, set from the JAX tree's params['a']. In float32
and bfloat16 serving the 256 px scale runs as one fused up-head site
(`up_head_site` in float32, `up_head_packed_site` in bfloat16): upscale8x's
features feed only conv_output. upscale2x and upscale4x stay plain, because
their features also feed residual24 / residual48. Without a site (int8
serving, calibration) upscale8x and conv_output run one after the other.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
from torch import nn

from tgsr_tpu_torch.ops.blocks import GLU, ResBlock, UpBlock, batch_norm, conv3x3
from tgsr_tpu_torch.ops.up_head import UpHeadWeights, fold_up_head
from tgsr_tpu_torch.utils.remat import remat


def _residual_seq(ngf: int) -> nn.Sequential:
    """conv3x3(ngf->2ngf) -> BN -> GLU -> conv3x3(ngf->ngf) -> BN, NO skip
    (the `residual24` / `residual48` Sequential, model.py:229-232)."""
    return nn.Sequential(conv3x3(ngf, ngf * 2), batch_norm(ngf * 2), GLU(),
                         conv3x3(ngf, ngf), batch_norm(ngf))


class NetGHighWeight(nn.Module):
    """= NetG_highweight. `remat` (JAX's remat 'high',
    tgsr_tpu/models/generator_hf.py:110-113): in train mode every ResBlock,
    residual sequence and UpBlock call is rematerialised
    (`utils/remat.py`); convin and the shared head run as they are."""

    # UpBlock convs (JAX paths) whose output feeds only the image head
    head_only_upblocks = frozenset({"upscale8x/conv"})

    def __init__(self, ngf: int = 32, n_res: int = 6, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.convin = nn.Sequential(conv3x3(3, ngf * 2), batch_norm(ngf * 2), GLU())
        self.residual = nn.Sequential(*[ResBlock(ngf) for _ in range(n_res)])
        self.upscale2x = UpBlock(ngf, ngf)
        self.residual24 = _residual_seq(ngf)
        self.upscale4x = UpBlock(ngf, ngf)
        self.residual48 = _residual_seq(ngf)
        self.upscale8x = UpBlock(ngf, ngf)
        # one 5x5 tanh head shared by the three scales (model.py:223-226)
        self.conv_output = nn.Sequential(
            nn.Conv2d(ngf, 3, 5, padding=2, bias=False), nn.Tanh())
        self.register_buffer("a", torch.tensor(0.5), persistent=False)

    def up_head_weights(self) -> UpHeadWeights:
        """`upscale8x` + the shared 5x5 head, folded for the kernel."""
        return fold_up_head(self.upscale8x, self.conv_output[0])

    def block(self, module: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """module(x), rematerialised where `remat` says so."""
        return remat(module, x) if self.remat and self.training else module(x)

    def trunk(self, lr: torch.Tensor) -> torch.Tensor:
        """convin, then the ResBlocks."""
        out = self.convin(lr)
        for res in self.residual:
            out = self.block(res, out)
        return out

    def forward(self, lr: torch.Tensor, srb: List[torch.Tensor],
                up_head: Optional[Callable[..., torch.Tensor]] = None
                ) -> List[torch.Tensor]:
        """lr NCHW, srb the low-frequency pyramid (NCHW) -> refined pyramid.
        `up_head` is the 256 px site function, `site(features, srb=, a=,
        use_tanh=) -> NCHW image`, made once by the caller from
        `up_head_weights()`; without it upscale8x and conv_output run as
        modules."""
        out = self.block(self.upscale2x, self.trunk(lr))
        ims2 = self.conv_output(out) + self.a * srb[0]
        out = self.block(self.upscale4x, self.block(self.residual24, out))
        ims4 = self.conv_output(out) + self.a * srb[1]
        out = self.block(self.residual48, out)
        if up_head is None:
            ims8 = self.conv_output(self.block(self.upscale8x, out)) + self.a * srb[2]
        else:
            ims8 = up_head(out, srb=srb[2], a=self.a, use_tanh=True)
        return [ims2, ims4, ims8]
