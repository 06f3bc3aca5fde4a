"""GAN losses, the BCE-with-logits family (counterpart of
tgsr_tpu/losses/gan.py `bce_with_logits`, `discriminator_loss` :55-91 and
`generator_loss` :94-142; = miscc/losses.py:290-391).

The discriminator comes in as closures per scale, as in the JAX package:
`d_features(img) -> features`, `d_cond(features, sent) -> [B] logits`,
`d_uncond(features) -> [B] logits` or None. The trainer's closures run the
port's `DNet` in train mode, so the call order below is the order in which
its BatchNorm running stats move. The DAMSM terms of `generator_loss` need
the image encoder, which is not ported yet (ROADMAP A 7); the other loss
families (the "or" family, unconditional, ESRGAN) wait with it.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

DClosures = Tuple[Callable, Callable, Optional[Callable]]


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable mean BCE with logits (= nn.BCEWithLogitsLoss),
    written as the JAX package writes it."""
    return torch.mean(torch.clamp(logits, min=0) - logits * targets
                      + torch.log1p(torch.exp(-logits.abs())))


def discriminator_loss(d_features: Callable, d_cond: Callable, d_uncond: Optional[Callable],
                       real_imgs: torch.Tensor, fake_imgs: torch.Tensor,
                       conditions: torch.Tensor) -> torch.Tensor:
    """= discriminator_loss (losses.py:290-316): real, fake, cond-real,
    cond-fake and cond-wrong (image i against caption i + 1, the first b - 1
    images) with (real + cond_real) / 2 + (fake + cond_fake + cond_wrong) / 3.
    The fake images are detached here (the reference's .detach())."""
    b = real_imgs.shape[0]
    ones = torch.ones(b, device=real_imgs.device)
    zeros = torch.zeros(b, device=real_imgs.device)
    real_features = d_features(real_imgs)
    fake_features = d_features(fake_imgs.detach())
    cond_real = bce_with_logits(d_cond(real_features, conditions), ones)
    cond_fake = bce_with_logits(d_cond(fake_features, conditions), zeros)
    cond_wrong = bce_with_logits(d_cond(real_features[:b - 1], conditions[1:b]), zeros[1:b])
    if d_uncond is not None:
        real_err = bce_with_logits(d_uncond(real_features), ones)
        fake_err = bce_with_logits(d_uncond(fake_features), zeros)
        return (real_err + cond_real) / 2.0 + (fake_err + cond_fake + cond_wrong) / 3.0
    return cond_real + (cond_fake + cond_wrong) / 2.0


def generator_loss(ds: Sequence[DClosures], image_encoder: Optional[Callable],
                   fake_imgs: Sequence[torch.Tensor], sent_emb: torch.Tensor,
                   words_embs: Optional[torch.Tensor] = None,
                   cap_lens: Optional[torch.Tensor] = None,
                   class_ids: Optional[torch.Tensor] = None,
                   gammas: Tuple[float, float, float] = (4.0, 5.0, 10.0),
                   smooth_lambda: float = 1.0, w: float = 1.0, s: float = 1.0,
                   g: float = 1.0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """= generator_loss (losses.py:351-391): per scale the cond (+ uncond)
    BCE against ones, times g. Returns (total, {"g_loss{i}": ...}).
    `image_encoder` must be None: the DAMSM word and sentence terms wait for
    the image encoder and losses/damsm.py (ROADMAP A 7)."""
    if image_encoder is not None:
        raise NotImplementedError("generator_loss with an image encoder: the DAMSM terms "
                                  "need the image encoder and losses/damsm.py, not ported "
                                  "yet (ROADMAP A 7)")
    b = sent_emb.shape[0]
    ones = torch.ones(b, device=sent_emb.device)
    total = 0.0
    logs: Dict[str, torch.Tensor] = {}
    for i, ((d_feat, d_cond, d_uncond), fake) in enumerate(zip(ds, fake_imgs)):
        features = d_feat(fake)
        loss = bce_with_logits(d_cond(features, sent_emb), ones)
        if d_uncond is not None:
            loss = bce_with_logits(d_uncond(features), ones) + loss
        loss = g * loss
        total = total + loss
        logs[f"g_loss{i}"] = loss
    return total, logs
