"""Quantized blocks of the generators (the PyTorch form of
tgsr_tpu/engine/quant.py `quant_interceptor`).

`quantize_generator(generator, sites, scales, split_glu, split_res)` returns
a copy of a loaded generator (cast to its compute dtype) whose convs with a
calibrated scale are int8 modules; convs without one run unquantized, as in
JAX. Weights are quantized once, here, from the cast weights, and kept as
buffers:

- `QuantConv` (im2f_conv, convin, the image heads, and the convs of a block
  outside `split_res`): quantize the input, int8 conv, output in the compute
  dtype; the BN and GLU that follow stay the generator's own modules. An
  int8 input was quantized by its producer with this conv's scale and goes in
  as it is.
- `QuantResBlock` (ResBlock and the residual sequences of `split_res`):
  conv1 over all 2c channels in one launch with the folded BN, glu_requant
  with conv2's scale, conv2 whose epilogue takes the float32 sums through
  its BN in float32, casts, and adds x (no skip for a residual sequence);
  a ResBlock without BN (the stage-1 generator's) folds none.
  One conv1 over 2c channels equals JAX's value/gate split bit for bit in
  int32: weight quantization and the conv are both separable by output
  channel.
- `QuantUpBlock`: quantize, int8 conv on the nearest-x2 upsample with the
  folded BN (an UpBlockNoBN has none: JAX quantizes its conv's upsampled
  input, the same int8 values), then GLU in the compute dtype; or, when its only consumer is an
  int8 head (FUSED_UP_OUT_CONSUMER, in the split set, and in the generator's
  `head_only_upblocks`: not the x16 upscale8x, whose 256 px output also
  feeds residual48), glu_requant with the head's scale, so the int8 leaves
  the block and the head skips its own quantize step (the same function as
  JAX's v*sigmoid(g), then the head's quantize_act).

Modules run NCHW views of NHWC tensors, as the rest of the generators.
"""

from __future__ import annotations

import copy
from typing import Mapping, Optional

import torch
from torch import nn

from tgsr_tpu_torch.engine.quant import (FUSED_UP_OUT_CONSUMER, act_step, bn_affine,
                                         quantize_kernel)
from tgsr_tpu_torch.ops.blocks import UpBlock, UpBlockNoBN, glu, nchw, nhwc
from tgsr_tpu_torch.ops.glu_requant import glu_requant, requant
from tgsr_tpu_torch.ops.int8_conv import Int8Weight, int8_conv, pack_int8_weight


class _Int8Conv(nn.Module):
    """A conv's int8 weight, its input scale and the dequantizing scale
    x_step * w_step (float32 [Cout]), made once from the cast weight."""

    def __init__(self, conv: nn.Conv2d, scale: float):
        super().__init__()
        if conv.bias is not None or conv.stride != (1, 1) or conv.dilation != (1, 1) \
                or conv.groups != 1 or conv.padding != (conv.kernel_size[0] // 2,) * 2:
            raise ValueError("int8 serving quantizes bias-free SAME stride-1 convs")
        wq, w_step = quantize_kernel(conv.weight.detach())
        self.in_scale = float(scale)
        x_step = torch.tensor(act_step(scale), dtype=torch.float32, device=w_step.device)
        w = pack_int8_weight(wq.permute(2, 3, 1, 0).contiguous())
        self.register_buffer("q", w.q)
        self.register_buffer("packed", w.packed)
        self.register_buffer("scale", x_step * w_step)

    @property
    def weight(self) -> Int8Weight:
        return Int8Weight(self.q, self.packed)

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW input -> int8 NHWC (an int8 input is taken as it is; the
        compute dtype's input goes through `requant`, the kernel on the card)."""
        x = nhwc(x)
        return x if x.dtype == torch.int8 else requant(x, self.in_scale)


class QuantConv(_Int8Conv):
    def __init__(self, conv: nn.Conv2d, scale: float, out_dtype: torch.dtype):
        super().__init__(conv, scale)
        self.out_dtype = out_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nchw(int8_conv(self.quantize(x), self.weight, self.scale,
                              out_dtype=self.out_dtype))


class QuantResBlock(nn.Module):
    """conv1 -> BN -> GLU -> conv2 -> BN [+ x] of a Sequential(conv, BN, GLU,
    conv, BN) (`block` of a ResBlock, or a residual sequence), or conv1 ->
    GLU -> conv2 [+ x] of a Sequential(conv, GLU, conv) (a no-BN ResBlock)."""

    def __init__(self, seq: nn.Sequential, scale1: float, scale2: float, skip: bool):
        super().__init__()
        use_bn = len(seq) == 5
        self.conv1 = _Int8Conv(seq[0], scale1)
        self.conv2 = _Int8Conv(seq[3 if use_bn else 2], scale2)
        self.use_bn = use_bn
        for name, bn in ((("bn1", seq[1]), ("bn2", seq[4])) if use_bn else ()):
            mul, add = bn_affine(bn)
            self.register_buffer(f"{name}_mul", mul)
            self.register_buffer(f"{name}_add", add)
        self.skip = skip

    def bn(self, i: int):
        return (getattr(self, f"bn{i}_mul"), getattr(self, f"bn{i}_add")) if self.use_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x in the compute dtype, bfloat16 or float32; conv1's output and
        the GLU in that dtype, as JAX's `_res_block_split`. conv2's epilogue
        is the JAX block's tail: float32 sums, BN in float32, the cast, + x."""
        h = int8_conv(self.conv1.quantize(x), self.conv1.weight, self.conv1.scale,
                      bn=self.bn(1), out_dtype=x.dtype)
        hq = glu_requant(h, self.conv2.in_scale)
        return nchw(int8_conv(hq, self.conv2.weight, self.conv2.scale, bn=self.bn(2),
                              residual=nhwc(x) if self.skip else None, out_dtype=x.dtype))


class QuantUpBlock(nn.Module):
    """nearest x2 -> int8 conv3x3 -> [BN] -> GLU; with `out_scale`, the GLU
    output leaves as int8 quantized with that (its head's) scale."""

    def __init__(self, up: nn.Sequential, scale: float, out_scale: Optional[float] = None):
        super().__init__()
        self.conv = _Int8Conv(up.conv, scale)
        self.use_bn = up.bn is not None
        if self.use_bn:
            mul, add = bn_affine(up.bn)
            self.register_buffer("bn_mul", mul)
            self.register_buffer("bn_add", add)
        self.out_scale = out_scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = (self.bn_mul, self.bn_add) if self.use_bn else None
        y = int8_conv(self.conv.quantize(x), self.conv.weight, self.conv.scale,
                      bn=bn, out_dtype=x.dtype, up2=True)
        if self.out_scale is not None:
            return nchw(glu_requant(y, self.out_scale))
        return nchw(glu(y, dim=-1))


def quantize_generator(generator: nn.Module, sites: Mapping[str, str],
                       scales: Mapping[str, float], split_glu: frozenset,
                       split_res: frozenset) -> nn.Module:
    """A copy of `generator` with its calibrated convs in int8. `sites` is
    the generator's table from JAX conv paths to module paths
    (`checkpoints.from_jax.conv_sites`); `scales` its scales group. The
    compute dtype is that of the generator's weights. A module bound under
    several names (the x16 family's tied stage and head) stays one module in
    the copy (`deepcopy` keeps the aliases), quantized once."""
    gen = copy.deepcopy(generator)
    out_dtype = next(gen.parameters()).dtype
    head_only = generator.head_only_upblocks  # UpBlocks whose output feeds only its head
    done = set()
    for key, path in sites.items():
        if not key.endswith("/conv1"):
            continue
        base, key2 = key[:-len("/conv1")], key[:-len("1")] + "2"
        if base in split_res and key in scales and key2 in scales:
            seq_path = path[:-len(".0")]
            skip = seq_path.endswith(".block")  # a ResBlock holds its Sequential as .block
            block_path = seq_path[:-len(".block")] if skip else seq_path
            gen.set_submodule(block_path, QuantResBlock(
                gen.get_submodule(seq_path), scales[key], scales[key2], skip))
            done |= {key, key2}
    for key, path in sites.items():
        if key in done or key not in scales:
            continue
        parent_path = path.rsplit(".", 1)[0]
        parent = gen.get_submodule(parent_path)
        if isinstance(parent, (UpBlock, UpBlockNoBN)):
            head = FUSED_UP_OUT_CONSUMER.get(key)
            out_scale = (scales[head] if key in split_glu and head in scales
                         and key in head_only else None)
            gen.set_submodule(parent_path, QuantUpBlock(parent, scales[key], out_scale))
        else:
            gen.set_submodule(path, QuantConv(gen.get_submodule(path), scales[key], out_dtype))
    return gen.eval()
