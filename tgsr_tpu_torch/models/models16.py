"""The x16 family's generators (counterpart of tgsr_tpu/models/models16.py;
= models16.py G_SR_NET_low and NetG_highweight, BRANCH_NUM 5).

They differ from the x8 generators by the reference's weight tying, which a
reference x16 checkpoint carries and which is kept here so that such a
`.pth` loads with `load_state_dict(strict=True)`:

- `GSRNetLow16`: h_net2, h_net3 and h_net4 are ONE NextStageG, and all four
  image heads are ONE GET_IMAGE_G (with tanh) (models16.py:13-14). The
  aliases are attributes bound to the same module, as in the reference, so
  `state_dict()` carries every alias key set and a quantized or cast copy
  (`copy.deepcopy`, `Module.to`) keeps one module with one set of weights.
- `NetGHighWeight16`: its blocks are untied, but the 512 px step reuses
  residual48 and upscale8x (models16.py:171-173), and without a weight map
  the last blend is against the 256 px SRb8 (models16.py:178), upsampled by
  nearest x2 to 512 px as the JAX package's documented deviation does; with
  one (a1..a4 at the pyramid's sizes) it is a4 * srb[3]. The declared
  residual816 and upscale16x never run (but under the library option
  `fix_bugs`); they exist exactly when the weights carry them (a reference
  `.pth` does, a JAX init does not), so that the weights fingerprint walks
  the same convs as the JAX package's.
- `NetGHigh16` (a library module, no entry point): every upscale block and
  every inter-scale residual sequence tied.

Serving sites, as in the x8 family (generator.py, generator_hf.py): the last
call of the shared stage (256 px features -> 512 px image, 3x3 head, tanh,
no blend) and the second call of upscale8x (256 px -> 512 px, the shared 5x5
tanh head, + a * nearest2x(srb[2])) feed only an image head, so they run as
one fused up-head site in float32 and bfloat16. The shared stage's first
three calls and upscale8x's 256 px call stay plain: their features also feed
the next stage or residual48.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tgsr_tpu_torch.config import Config, check_served
from tgsr_tpu_torch.models.generator import GetImageG, GSRNetLow, GSRNetLowStage1
from tgsr_tpu_torch.models.generator_hf import (X8_MAP_SIZES, NetGHighWeight, _conv_in,
                                                _conv_output, _residual_seq)
from tgsr_tpu_torch.ops.blocks import ResBlock, UpBlock
from tgsr_tpu_torch.utils.remat import remat_policy

# the declared blocks of NetG_highweight (x16) that its forward never runs
UNUSED_BLOCKS = ("residual816", "upscale16x")


class GSRNetLow16(GSRNetLow):
    """= models16.G_SR_NET_low: four stages, h_net2 == h_net3 == h_net4 and
    img_net1 == .. == img_net4 (tanh heads). The forward is GSRNetLow's over
    the aliases; the last stage's site is the shared stage's upsample and
    the shared head."""

    tied = True
    # the shared stage's upsample feeds the next stage on its first calls
    head_only_upblocks = frozenset()

    def __init__(self, ngf: int = 32, cdf: int = 256, c_dim: int = 100, r_num: int = 2,
                 remat: bool = False):
        super().__init__(ngf, cdf, c_dim, n_stages=2, r_num=r_num, remat=remat)
        self.n_stages = 4
        self.h_net3 = self.h_net4 = self.h_net2
        self.img_net1 = GetImageG(ngf, use_tanh=True)
        self.img_net2 = self.img_net3 = self.img_net4 = self.img_net1


class NetGHighWeight16(NetGHighWeight):
    """= models16.NetG_highweight: four scales, 64 to 512 px. `low` is
    EVAL.INPUT_NETGH; `weightmap` EVAL.WEIGHTMAP, with the maps a1..a4 at
    `sizes` (the config's pyramid sizes, as JAX's SRPipeline and GANTrainer
    pass them). `unused` names the blocks of UNUSED_BLOCKS the weights
    carry; they are declared and run only with `fix_bugs` (JAX's
    fix_bugs=True, models16.py:164-166: residual816 and upscale16x make the
    512 px step, blended with srb[3]; a library option, no entry point sets
    it)."""

    # upscale8x's 256 px output feeds residual48 as well as the head
    head_only_upblocks = frozenset()

    def __init__(self, ngf: int = 32, n_res: int = 6, unused: Tuple[str, ...] = (),
                 remat: bool = False, low: str = "lr", weightmap: bool = False,
                 sizes: Sequence[int] = (64, 128, 256, 512), fix_bugs: bool = False):
        super().__init__(ngf, n_res, remat=remat, low=low, weightmap=weightmap, sizes=sizes)
        self.fix_bugs = fix_bugs
        if fix_bugs:
            unused = UNUSED_BLOCKS
        if "residual816" in unused:
            self.residual816 = _residual_seq(ngf)
        if "upscale16x" in unused:
            self.upscale16x = UpBlock(ngf, ngf)

    def forward(self, lr: torch.Tensor, srb: List[torch.Tensor],
                up_head: Optional[Callable[..., torch.Tensor]] = None
                ) -> List[torch.Tensor]:
        """lr NCHW in the compute dtype, srb the low branch's four images
        (NCHW) -> the refined 64, 128, 256 and 512 px images. `up_head` is
        the 512 px site (the second call of upscale8x with the shared head),
        `site(features, srb=, a=, use_tanh=)`; without it upscale8x and
        conv_output run as modules."""
        block = self.block
        w = self.blend_weights(srb)
        out = block(self.upscale2x, self.trunk(lr))
        ims = [self.conv_output(out) + w[0] * srb[0]]
        out = block(self.upscale4x, block(self.residual24, out))
        ims.append(self.conv_output(out) + w[1] * srb[1])
        out = block(self.upscale8x, block(self.residual48, out))
        ims.append(self.conv_output(out) + w[2] * srb[2])
        if self.fix_bugs:
            out = block(self.upscale16x, block(self.residual816, out))
            ims.append(self.conv_output(out) + w[3] * srb[3])
            return ims
        # models16.py:171-178: residual48 and upscale8x again, blended with
        # srb[3] under a weight map, else with SRb8 (srb[2]) brought to
        # 512 px by nearest x2
        out = block(self.residual48, out)
        last = srb[3] if self.weightmap else F.interpolate(srb[2], scale_factor=2,
                                                           mode="nearest")
        if up_head is None:
            ims.append(self.conv_output(block(self.upscale8x, out)) + w[3] * last)
        else:
            ims.append(up_head(out, srb=last, a=w[3], use_tanh=True))
        return ims


class NetGHigh16(nn.Module):
    """= models16.NetG_high (JAX's NetGHigh16, tgsr_tpu/models/models16.py:72):
    NetG_high over four scales with every upscale block tied (one UpBlock,
    bound as upscale2x, upscale4x and upscale8x) and every inter-scale
    residual sequence tied (residual24 = residual48), models16.py:48, 53;
    ims_s = conv_output(feat_s) + srb_s. The input is the blurred LR (`low`)
    or the LR less its blur, the blur the caller's. A library module; NCHW."""

    def __init__(self, ngf: int = 32, n_res: int = 6):
        super().__init__()
        self.convin = _conv_in(ngf)
        self.residual = nn.Sequential(*[ResBlock(ngf) for _ in range(n_res)])
        self.upscale2x = self.upscale4x = self.upscale8x = UpBlock(ngf, ngf)
        self.residual24 = self.residual48 = _residual_seq(ngf)
        self.conv_output = _conv_output(ngf)

    def forward(self, lr: torch.Tensor, srb: List[torch.Tensor], lr_blur: torch.Tensor,
                low: bool = False) -> List[torch.Tensor]:
        out = self.upscale2x(self.residual(self.convin(lr_blur if low else lr - lr_blur)))
        ims = [self.conv_output(out) + srb[0]]
        for k in range(1, 4):
            out = self.upscale2x(self.residual24(out))
            ims.append(self.conv_output(out) + srb[k])
        return ims


def make_generators(cfg: Config, unused: Tuple[str, ...] = (), remat=False,
                    fused_upsample: bool = False) -> Tuple[nn.Module, nn.Module]:
    """(netG, netGH) of cfg's family, fresh, float32 on the CPU: the
    reference's family switch (trainer_objective.py:74-88) as JAX's
    SRPipeline makes it (tgsr_tpu/engine/inference.py:80-108): BRANCH_NUM 4
    the x8 generators (GSRNetLowStage1 under EVAL.STAGE1), 5 the x16 ones
    (STAGE1 not read: JAX builds GSRNetLow16 whatever it says); netGH reads
    EVAL.INPUT_NETGH and EVAL.WEIGHTMAP (x8 maps at X8_MAP_SIZES whatever the
    base size, x16 maps at the pyramid's sizes). `unused`: the x16 netGH's
    declared blocks that the weights carry. `remat`: the JAX trainer's
    policy, False / True / 'all' / 'low' / 'high' (`utils/remat.remat_policy`).
    `fused_upsample`: the x8 generators' UpBlocks in their fused form (JAX's
    SRPipeline passes it to the x8 family alone; x16 and stage 1 ignore it)."""
    ngf, emb, ev = cfg.GAN.GF_DIM, cfg.TEXT.EMBEDDING_DIM, cfg.EVAL
    low, high = remat_policy(remat)
    hf = {"low": ev.INPUT_NETGH, "weightmap": ev.WEIGHTMAP}
    if check_served(cfg).TREE.BRANCH_NUM == 5:
        return (GSRNetLow16(ngf, emb, cfg.GAN.CONDITION_DIM, cfg.GAN.R_NUM, remat=low),
                NetGHighWeight16(ngf, unused=unused, remat=high,
                                 sizes=tuple(cfg.pyramid_sizes()), **hf))
    if ev.STAGE1:
        netg = GSRNetLowStage1(ngf, emb, cfg.GAN.CONDITION_DIM, cfg.GAN.R_NUM)
    else:
        netg = GSRNetLow(ngf, emb, cfg.GAN.CONDITION_DIM, cfg.n_stages, cfg.GAN.R_NUM,
                         remat=low, fused_upsample=fused_upsample)
    return netg, NetGHighWeight(ngf, remat=high, sizes=X8_MAP_SIZES,
                                fused_upsample=fused_upsample, **hf)


def unused_blocks(netgh_sd) -> Tuple[str, ...]:
    """The blocks of UNUSED_BLOCKS a netGH state dict carries."""
    return tuple(name for name in UNUSED_BLOCKS if any(k.startswith(name + ".") for k in netgh_sd))
