"""GAN losses, the BCE-with-logits family (counterpart of
tgsr_tpu/losses/gan.py `bce_with_logits`, `discriminator_loss` :55-91 and
`generator_loss` :94-142; = miscc/losses.py:290-391).

The discriminator comes in as closures per scale, as in the JAX package:
`d_features(img) -> features`, `d_cond(features, sent) -> [B] logits`,
`d_uncond(features) -> [B] logits` or None. The trainer's closures run the
port's `DNet` in train mode, so the call order below is the order in which
its BatchNorm running stats move. `generator_loss` adds the DAMSM word and
sentence terms when it is given an image encoder. The other loss families
(the "or" family, unconditional, ESRGAN) are not ported (ROADMAP A 7).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from tgsr_tpu_torch.losses.damsm import sent_loss, words_loss

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
    BCE against ones, times g; with an `image_encoder` (fake image ->
    (region features [B, R, E], code [B, E])) on the finest fake, the DAMSM
    words loss times w and the sentence loss times s, both times
    `smooth_lambda`. Returns (total, {"g_loss{i}": ..., "w_loss",
    "s_loss"})."""
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
    if image_encoder is not None:
        if words_embs is None or cap_lens is None:
            raise ValueError("generator_loss with an image encoder: the DAMSM terms need "
                             "words_embs and cap_lens")
        region_features, cnn_code = image_encoder(fake_imgs[-1])
        w0, w1, _ = words_loss(region_features, words_embs, cap_lens, class_ids, *gammas)
        s0, s1 = sent_loss(cnn_code, sent_emb, class_ids, gammas[2])
        logs["w_loss"] = w * (w0 + w1) * smooth_lambda
        logs["s_loss"] = s * (s0 + s1) * smooth_lambda
        total = total + logs["w_loss"] + logs["s_loss"]
    return total, logs
