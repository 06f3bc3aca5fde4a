"""High-frequency SRResNet branch (counterpart of
tgsr_tpu/models/generator_hf.py; = NetG_highweight, model.py:212-298, and the
library variants NetG_high, model.py:133-209, and NetG_high_SR_weight,
model.py:301-336).

NetGHighWeight: ims_s = conv_output(feat_s) + w_s * srb_s at 64, 128 and
256 px, from the input EVAL.INPUT_NETGH names (`low`): the LR image ('lr'),
its blur ('lrblur') or the LR less its blur ('lr-lrblur'), the blur taken
inside the forward (`lr_blur`), so every caller (the serving forward, a
captured graph, an exported program, calibration, the trainer) runs it.
Without a weight map w_s is one blend weight `a` for all three scales; it is
not in the reference's state dict (model.py:246-248), so it is a
non-persistent buffer here, set from the JAX tree's params['a']. With one
(EVAL.WEIGHTMAP) w_s is the parameter a1, a2, a3: a per-pixel map at 64, 128
and 256 px, whatever the base size, as JAX's SRPipeline builds it (no
`sizes`, tgsr_tpu/engine/inference.py:90-95), broadcast over batch and
channel; there is no `a`. Where a map's size is not its image's (another base
size, an arbitrary LR) the forward raises ValueError naming both, where JAX
fails at a broadcast.

In float32 and bfloat16 serving the 256 px scale runs as one fused up-head
site (`up_head_site` in float32, `up_head_packed_site` in bfloat16), with the
scalar or the a3 map: upscale8x's features feed only conv_output. upscale2x
and upscale4x stay plain, because their features also feed residual24 /
residual48. Without a site (int8 serving, calibration) upscale8x and
conv_output run one after the other.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
from torch import nn

from tgsr_tpu_torch.config import SERVED_INPUT_NETGH
from tgsr_tpu_torch.ops.blocks import (GLU, ResBlock, UpBlock, batch_norm, conv3x3,
                                       depth_to_space, nchw, nhwc, space_to_depth)
from tgsr_tpu_torch.ops.image import blur_half_support, gaussian_blur
from tgsr_tpu_torch.ops.up_head import UpHeadWeights, fold_up_head
from tgsr_tpu_torch.utils.remat import remat

# the x8 weight maps' sizes, JAX's NetGHighWeight.sizes (a1, a2, a3)
X8_MAP_SIZES = (64, 128, 256)
BLUR_RADIUS = 2.0  # PIL GaussianBlur(2), the reference's LRimb (datasets.py:71-109)


def lr_blur(lr: torch.Tensor) -> torch.Tensor:
    """The blurred LR of the HF branch (= JAX's SRPipeline._lr_blur,
    tgsr_tpu/engine/inference.py:277-285): the compute-dtype LR (NCHW)
    blurred in float32 (float64 for a float64 LR) and cast back."""
    x = nhwc(lr).to(torch.promote_types(lr.dtype, torch.float32))
    return nchw(gaussian_blur(x, BLUR_RADIUS)).to(lr.dtype)


def hf_input(low: str, lr: torch.Tensor) -> torch.Tensor:
    """The HF branch's input for EVAL.INPUT_NETGH `low`."""
    if low == "lr":
        return lr
    blur = lr_blur(lr)
    return blur if low == "lrblur" else lr - blur


def _residual_seq(ngf: int, cin: Optional[int] = None) -> nn.Sequential:
    """conv3x3(cin->2ngf) -> BN -> GLU -> conv3x3(ngf->ngf) -> BN, NO skip
    (the `residual24` / `residual48` Sequential, model.py:229-232); cin is
    ngf unless given (NetG_high's cat mode reads 6 channels)."""
    return nn.Sequential(conv3x3(cin or ngf, ngf * 2), batch_norm(ngf * 2), GLU(),
                         conv3x3(ngf, ngf), batch_norm(ngf))


def _conv_in(ngf: int, cin: int = 3) -> nn.Sequential:
    """conv3x3(cin -> 2ngf) -> BN -> GLU (the `convin` Sequential)."""
    return nn.Sequential(conv3x3(cin, ngf * 2), batch_norm(ngf * 2), GLU())


def _conv_output(ngf: int) -> nn.Sequential:
    """The 5x5 tanh head shared by the scales (model.py:223-226)."""
    return nn.Sequential(nn.Conv2d(ngf, 3, 5, padding=2, bias=False), nn.Tanh())


class WeightMapSizeError(ValueError):
    """A weight map whose size is not its image's (an LR other than the one
    the maps were made for); the HTTP front door answers it 400."""


def check_maps(maps: Sequence[torch.Tensor], srb: Sequence[torch.Tensor]) -> None:
    """WeightMapSizeError where a weight map's size is not its image's."""
    for i, (a, s) in enumerate(zip(maps, srb), 1):
        if tuple(a.shape) != tuple(s.shape[-2:]):
            raise WeightMapSizeError(f"EVAL.WEIGHTMAP: the weight map a{i} is {a.shape[0]} x "
                             f"{a.shape[1]} px, the image it blends is {s.shape[-2]} x "
                             f"{s.shape[-1]} px (the maps' sizes are fixed by the weights)")


class NetGHighWeight(nn.Module):
    """= NetG_highweight. `low` is EVAL.INPUT_NETGH, `weightmap`
    EVAL.WEIGHTMAP. `remat` (JAX's remat 'high',
    tgsr_tpu/models/generator_hf.py:110-113): in train mode every ResBlock,
    residual sequence and UpBlock call is rematerialised
    (`utils/remat.py`); convin and the shared head run as they are.
    `fused_upsample` (JAX's, tgsr_tpu/models/generator_hf.py:135-144): the
    three UpBlocks in their fused form (the served 256 px up-head site
    fuses its upsample either way)."""

    # UpBlock convs (JAX paths) whose output feeds only the image head
    head_only_upblocks = frozenset({"upscale8x/conv"})
    has_up_head_site = True  # the last scale runs as one fused up-head site when served

    def __init__(self, ngf: int = 32, n_res: int = 6, remat: bool = False, low: str = "lr",
                 weightmap: bool = False, sizes: Sequence[int] = X8_MAP_SIZES,
                 fused_upsample: bool = False):
        super().__init__()
        if low not in SERVED_INPUT_NETGH:
            raise ValueError(f"INPUT_NETGH {low!r}: one of {SERVED_INPUT_NETGH}")
        self.remat = remat
        self.low = low
        self.weightmap = weightmap
        self.convin = _conv_in(ngf)
        self.residual = nn.Sequential(*[ResBlock(ngf) for _ in range(n_res)])
        self.upscale2x = UpBlock(ngf, ngf, fused_upsample)
        self.residual24 = _residual_seq(ngf)
        self.upscale4x = UpBlock(ngf, ngf, fused_upsample)
        self.residual48 = _residual_seq(ngf)
        self.upscale8x = UpBlock(ngf, ngf, fused_upsample)
        self.conv_output = _conv_output(ngf)
        if weightmap:  # a1, a2, ... at `sizes`, ones (JAX's init)
            for i, size in enumerate(sizes, 1):
                setattr(self, f"a{i}", nn.Parameter(torch.ones(size, size)))
        else:
            self.register_buffer("a", torch.tensor(0.5), persistent=False)

    def blend_weights(self, srb: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The blend weight of each scale of srb: its map (checked against
        the image's size), or `a`."""
        if not self.weightmap:
            return [self.a] * len(srb)
        maps = [getattr(self, f"a{i}") for i in range(1, len(srb) + 1)]
        check_maps(maps, srb)
        return maps

    def up_head_weights(self) -> UpHeadWeights:
        """`upscale8x` + the shared 5x5 head, folded for the kernel."""
        return fold_up_head(self.upscale8x, self.conv_output[0])

    def block(self, module: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """module(x), rematerialised where `remat` says so."""
        return remat(module, x) if self.remat and self.training else module(x)

    def low_input(self, lr: torch.Tensor) -> torch.Tensor:
        """The input `low` names (`hf_input`); parallel/spatial.py runs a
        row-sharded copy's on its rows and `low_input_halo` more each way."""
        return hf_input(self.low, lr)

    @property
    def low_input_halo(self) -> int:
        """The rows above and below a row that `low_input` reads: the blur's
        half support, none for 'lr'."""
        return 0 if self.low == "lr" else blur_half_support(BLUR_RADIUS)

    def trunk(self, lr: torch.Tensor) -> torch.Tensor:
        """The input `low` names, convin, then the ResBlocks."""
        out = self.convin(self.low_input(lr))
        for res in self.residual:
            out = self.block(res, out)
        return out

    def forward(self, lr: torch.Tensor, srb: List[torch.Tensor],
                up_head: Optional[Callable[..., torch.Tensor]] = None
                ) -> List[torch.Tensor]:
        """lr NCHW in the compute dtype, srb the low-frequency pyramid (NCHW)
        -> refined pyramid. `up_head` is the 256 px site function,
        `site(features, srb=, a=, use_tanh=) -> NCHW image`, made once by the
        caller from `up_head_weights()`; without it upscale8x and conv_output
        run as modules."""
        w = self.blend_weights(srb)
        out = self.block(self.upscale2x, self.trunk(lr))
        ims2 = self.conv_output(out) + w[0] * srb[0]
        out = self.block(self.upscale4x, self.block(self.residual24, out))
        ims4 = self.conv_output(out) + w[1] * srb[1]
        out = self.block(self.residual48, out)
        if up_head is None:
            ims8 = self.conv_output(self.block(self.upscale8x, out)) + w[2] * srb[2]
        else:
            ims8 = up_head(out, srb=srb[2], a=w[2], use_tanh=True)
        return [ims2, ims4, ims8]


class NetGHigh(nn.Module):
    """= NetG_high (model.py:133-209; JAX's NetGHigh,
    tgsr_tpu/models/generator_hf.py:150): ims_s = conv_output(feat_s) +
    srb_s, no blend weight. The input is the blurred LR (`low`) or the LR
    less its blur. In `cat` mode convin reads [LR - blur, blur] (6 channels),
    there are no ResBlocks, each scale's image is conv_output alone, and
    residual24 / residual48 read [the image, srb] (6 channels). A library
    module: no JAX entry point builds it. NCHW in and out; the blurred LR is
    the caller's, as in JAX."""

    def __init__(self, ngf: int = 32, cat: bool = False, n_res: int = 6):
        super().__init__()
        self.cat = cat
        self.convin = _conv_in(ngf, 6 if cat else 3)
        if not cat:
            self.residual = nn.Sequential(*[ResBlock(ngf) for _ in range(n_res)])
        self.upscale2x = UpBlock(ngf, ngf)
        self.residual24 = _residual_seq(ngf, 6 if cat else None)
        self.upscale4x = UpBlock(ngf, ngf)
        self.residual48 = _residual_seq(ngf, 6 if cat else None)
        self.upscale8x = UpBlock(ngf, ngf)
        self.conv_output = _conv_output(ngf)

    def forward(self, lr: torch.Tensor, srb: List[torch.Tensor],
                lr_blur: torch.Tensor, low: bool = False) -> List[torch.Tensor]:
        """-> [ims2, ims4, ims8]."""
        co = self.conv_output
        if self.cat:
            out = self.upscale2x(self.convin(torch.cat([lr - lr_blur, lr_blur], 1)))
            ims2 = co(out)
            out = self.upscale4x(self.residual24(torch.cat([ims2, srb[0]], 1)))
            ims4 = co(out)
            out = self.upscale8x(self.residual48(torch.cat([ims4, srb[1]], 1)))
            return [ims2, ims4, co(out)]
        out = self.residual(self.convin(lr_blur if low else lr - lr_blur))
        f1 = self.upscale2x(out)
        f2 = self.upscale4x(self.residual24(f1))
        f3 = self.upscale8x(self.residual48(f2))
        return [co(f) + s for f, s in zip((f1, f2, f3), srb)]


class NetGHighSRWeight(nn.Module):
    """= NetG_high_SR_weight (model.py:301-336; JAX's NetGHighSRWeight,
    tgsr_tpu/models/generator_hf.py:212): the LR through convin1, the shared
    residual sequence and upscale2x; the finest srb space-to-depth by 4
    through convin and the same residual sequence; both concatenated, a
    conv3x3 -> BN -> GLU to 16 ngf channels, depth-to-space by 4, the 5x5
    tanh head + a * srb with a `size` x `size` weight map `a`. The reference
    ties residual1 and residual to one Sequential (model.py:312): one module
    bound under both names, so its state dict carries both key sets (JAX's
    convert_netgh_sr_weight reads `residual`). A library module; NCHW."""

    def __init__(self, ngf: int = 32, size: int = 256):
        super().__init__()
        self.convin1 = _conv_in(ngf)
        self.residual1 = self.residual = _residual_seq(ngf)
        self.upscale2x = UpBlock(ngf, ngf)
        self.convin = _conv_in(ngf, 3 * 16)
        self.convmd = nn.Sequential(conv3x3(ngf * 2, ngf * 32), batch_norm(ngf * 32), GLU())
        self.conv_output = _conv_output(ngf)
        self.a = nn.Parameter(torch.ones(size, size))

    def forward(self, lr: torch.Tensor, srb: List[torch.Tensor], lr_blur=None):
        """-> ([im], a); `lr_blur` is not read (as in JAX)."""
        xlr = self.upscale2x(self.residual(self.convin1(lr)))
        sr = srb[-1]
        out = self.residual(self.convin(nchw(space_to_depth(nhwc(sr), 4))))
        out2 = nchw(depth_to_space(nhwc(self.convmd(torch.cat([xlr, out], 1))), 4))
        check_maps([self.a], [sr])
        return [self.conv_output(out2) + self.a * sr], self.a
