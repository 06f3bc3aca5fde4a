"""Pixel-fidelity and VAE losses (counterpart of tgsr_tpu/losses/pixel.py,
:16-62; = MSE, CycleMSE, weight_MSE and KL_loss, miscc/losses.py:779-810).

Images in the JAX package's layout, NHWC, where the layout matters
(`cycle_mse`, `weight_mse`); `mse_pyramid` and `kl_loss` are means and take
any layout, the same on both sides. The trainer's path runs `mse_pyramid`
and `kl_loss`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from tgsr_tpu_torch.ops.image import resize_bicubic_torch


def mse_pyramid(fake: Sequence[torch.Tensor], label: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of per-scale MSE over the image pyramid (= MSE, losses.py:779-784)."""
    return sum(torch.mean((f - l) ** 2) for f, l in zip(fake, label))


def cycle_mse(fake_sr: Sequence[torch.Tensor], real_lr: torch.Tensor) -> torch.Tensor:
    """Each fake SR scale (NHWC) resized to the LR's size by torch's bicubic
    (F.interpolate, no antialias), MSE against the LR (= CycleMSE,
    losses.py:785-790)."""
    h, w = real_lr.shape[1:3]
    return sum(torch.mean((resize_bicubic_torch(f, (h, w)) - real_lr) ** 2) for f in fake_sr)


def weight_mse(fake: Sequence[torch.Tensor], label: Sequence[torch.Tensor],
               attn_maps: Sequence[torch.Tensor]
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Attention-weighted MSE (= weight_MSE, losses.py:792-804): w = max over
    words of each attention map [B, T, h, w], nearest-upsampled to the image
    (NHWC), l2 = T * w * (f - l)^2 averaged over all of it. Returns (loss, the
    last scale's weight map [B, H, W, 1])."""
    loss, w_last = 0.0, None
    for f, l, a in zip(fake, label, attn_maps):
        t = a.shape[1]
        w = a.amax(dim=1, keepdim=True).permute(0, 2, 3, 1)  # [B, h, w, 1]
        factor = f.shape[1] // w.shape[1]
        if factor > 1:
            w = w.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)
        loss = loss + torch.mean((t * w) * (f - l) ** 2)
        w_last = w
    return loss, w_last


def kl_loss(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """-0.5 * mean(1 + logvar - mu^2 - exp(logvar)) (= KL_loss,
    losses.py:806-810: the mean over all elements)."""
    return -0.5 * torch.mean(1.0 + logvar - mu ** 2 - torch.exp(logvar))
