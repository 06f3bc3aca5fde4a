"""Deconvnet feature visualisation over VGG16 (counterpart of
tgsr_tpu/utils/deconv_viz.py; the reference's vis_layer / vis_layeror,
miscc/utils.py:488-592, whose vgg16_conv / vgg16_deconv classes its
snapshot lacks).

For one conv layer of the VGG16 tower, the feature map with the largest
activation is kept, thresholded (`_select_seed`), and taken back to pixel
space by the deconvnet: max-unpooling at the forward's switches, the
transposed convolutions with the tied weights, and a ReLU on the backward
signal (Zeiler and Fergus). As in JAX, that inverse is the input gradient of
the forward tower whose ReLU's backward rule is relu(g) (`DeconvReLU`):
the gradient of a max-pool is the unpooling at its switches, and that of a
conv is the tied transposed conv. So `vis_layer` runs `torch.autograd.grad`
through `forward_to_tap`, the tower of `models.vgg.VGG16Features`, not a
mirrored network. Images are NHWC in [-1, 1], as JAX's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tgsr_tpu_torch.models.vgg import _CFG, CONV_INDICES, VGG16Features
from tgsr_tpu_torch.ops.blocks import nchw, nhwc


class DeconvReLU(torch.autograd.Function):
    """ReLU whose backward rectifies the incoming signal instead of gating
    it by the forward's mask (JAX's `deconv_relu`, a custom VJP)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return torch.relu(g)


def deconv_relu(x: torch.Tensor) -> torch.Tensor:
    return DeconvReLU.apply(x)


def forward_to_tap(vgg: VGG16Features, x: torch.Tensor, layer: int) -> torch.Tensor:
    """The VGG16 tower up to conv layer `layer` (0..12, torchvision order),
    every ReLU a `deconv_relu`, a 2 x 2 max-pool between the blocks: x NHWC
    [B, H, W, 3] in [-1, 1] -> the post-ReLU map NHWC [B, h, w, C]."""
    n_layers = len(CONV_INDICES)
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer must be in [0, {n_layers}), got {layer}")
    h = ((nchw(x) + 1.0) / 2.0 - vgg.mean.to(x.dtype)) / vgg.std.to(x.dtype)
    li = 0
    for bi, (_, n_convs) in enumerate(_CFG):
        for _ in range(n_convs):
            conv = vgg.features[CONV_INDICES[li]]
            h = deconv_relu(F.conv2d(h, conv.weight, conv.bias, padding=1))
            if li == layer:
                return nhwc(h)
            li += 1
        if bi < len(_CFG) - 1:
            h = F.max_pool2d(h, 2, 2)
    raise AssertionError  # unreachable: layer checked above


def _select_seed(fmap: np.ndarray, mode: str) -> Tuple[np.ndarray, float]:
    """The reference's selection (miscc/utils.py:537-589), as JAX's: keep the
    channel with the largest single activation and threshold it. `mode`
    'max' keeps its max pixel (vis_layeror), 'mean' the pixels at or above
    its mean, 'four' those at or above its 10th percentile (midpoint rule;
    the reference's default), 'all' the whole map. fmap [H, W, C] ->
    (seed [H, W, C], the max activation)."""
    c = fmap.shape[-1]
    mark = int(np.argmax(fmap.reshape(-1, c).max(axis=0)))
    choose = fmap[:, :, mark]
    max_act = float(choose.max())
    if mode == "all":
        return fmap.copy(), max_act
    if mode == "max":
        thresh_map = np.where(choose == max_act, choose, 0.0)
    elif mode == "mean":
        thresh_map = np.where(choose >= choose.mean(), choose, 0.0)
    elif mode == "four":
        q = np.percentile(choose, 10, method="midpoint")
        thresh_map = np.where(choose >= q, choose, 0.0)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    seed = np.zeros_like(fmap)
    seed[:, :, mark] = thresh_map
    return seed, max_act


def vis_layer(vgg: VGG16Features, image, layer: int, mode: str = "four"
              ) -> Tuple[np.ndarray, int]:
    """Deconvnet visualisation of conv layer `layer` for one image
    ([H, W, 3] or [1, H, W, 3], NHWC in [-1, 1], on the VGG's device):
    (uint8 [H, W, 3], the reconstruction min-max scaled to 0..255 and
    truncated, int(max activation)), as the reference returns them."""
    p = next(vgg.parameters())
    x = torch.as_tensor(np.asarray(image) if not torch.is_tensor(image) else image,
                        dtype=p.dtype, device=p.device)
    if x.dim() == 3:
        x = x[None]
    with torch.no_grad():
        feats = forward_to_tap(vgg, x, layer)
    seed, max_act = _select_seed(feats[0].cpu().numpy(), mode)
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        tap = forward_to_tap(vgg, xg, layer)
        (recon,) = torch.autograd.grad(tap, xg, grad_outputs=torch.as_tensor(
            seed, dtype=tap.dtype, device=tap.device)[None])
    img = recon[0].float().cpu().numpy()
    lo, hi = img.min(), img.max()
    img = (img - lo) / max(hi - lo, 1e-12) * 255.0
    return img.astype(np.uint8), int(max_act)
