"""The ManiGAN loss family (counterpart of tgsr_tpu/losses/mani.py; =
miscc/losses.py:583-748): discriminator_lossMani, generator_lossMani,
DCM_generator_loss and word_level_correlation. Library functions that no
trainer calls, with the closures of `losses/gan.py`.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from tgsr_tpu_torch.losses.damsm import cosine_similarity
from tgsr_tpu_torch.losses.gan import (DClosures, _damsm_terms, bce_on_sigmoid,
                                       discriminator_loss)
from tgsr_tpu_torch.ops.attention import NEG_INF, func_attention


def word_level_correlation(img_features: torch.Tensor, words_emb: torch.Tensor,
                           cap_lens: torch.Tensor, labels: torch.Tensor,
                           gamma1: float = 4.0, gamma2: float = 5.0) -> torch.Tensor:
    """= word_level_correlation (losses.py:706-748): per sample, the words'
    attention over its own regions weighted by the words' self-attention
    against their mean, scored by cosine with the words, log-sum-exp over
    the unpadded words, sigmoid, then BCE against `labels`. img_features
    [B, R, E], words_emb [B, T, E], cap_lens [B]. A value without a
    gradient: the reference builds its list with requires_grad=False
    (losses.py:745), JAX applies stop_gradient, and this detaches."""
    t = words_emb.shape[1]
    cap_lens = torch.as_tensor(cap_lens, device=words_emb.device)
    mask = torch.arange(t, device=words_emb.device)[None, :] >= cap_lens[:, None]  # [B, T]
    ctx, _ = func_attention(words_emb, img_features, gamma1, word_mask=mask)  # [B, T, E]
    denom = torch.clamp((~mask).sum(dim=1), min=1).to(words_emb.dtype)
    aver = words_emb.masked_fill(mask[:, :, None], 0).sum(dim=1) / denom[:, None]  # [B, E]
    res = torch.einsum("be,bte->bt", aver, words_emb).masked_fill(mask, NEG_INF)
    self_ctx = ctx * torch.softmax(res, dim=-1)[:, :, None]
    sim = (cosine_similarity(words_emb, self_ctx) * gamma2).masked_fill(mask, NEG_INF)
    sims = torch.sigmoid(torch.logsumexp(sim, dim=-1)).detach()
    sims = torch.clamp(sims, 1e-7, 1 - 1e-7)
    labels = torch.as_tensor(labels, dtype=sims.dtype, device=sims.device)
    return -torch.mean(labels * torch.log(sims) + (1 - labels) * torch.log1p(-sims))


def discriminator_loss_mani(d_features: Callable, d_cond: Callable,
                            d_uncond: Optional[Callable], real_imgs: torch.Tensor,
                            fake_imgs: torch.Tensor, conditions: torch.Tensor,
                            image_encoder: Callable, words_embs: torch.Tensor,
                            cap_lens: torch.Tensor, gamma1: float = 4.0,
                            gamma2: float = 5.0) -> torch.Tensor:
    """= discriminator_lossMani (losses.py:583-618): `discriminator_loss` plus
    the real images' word-level correlation against ones."""
    err = discriminator_loss(d_features, d_cond, d_uncond, real_imgs, fake_imgs, conditions)
    region_features, _ = image_encoder(real_imgs)
    ones = torch.ones(real_imgs.shape[0], device=real_imgs.device)
    return err + word_level_correlation(region_features, words_embs, cap_lens, ones,
                                        gamma1, gamma2)


def generator_loss_mani(ds: Sequence[DClosures], image_encoder: Callable,
                        vgg_apply: Callable, fake_imgs: Sequence[torch.Tensor],
                        real_imgs: Sequence[torch.Tensor], sent_emb: torch.Tensor,
                        words_embs: torch.Tensor, cap_lens: torch.Tensor,
                        class_ids: Optional[torch.Tensor], gammas=(4.0, 5.0, 10.0),
                        smooth_lambda: float = 1.0):
    """= generator_lossMani (losses.py:619-667): per scale the adversarial
    terms, the DAMSM terms on the finest fake, and the VGG perceptual MSE
    (`vgg_apply`: image -> list of feature maps) over every scale and tap,
    divided by 3. Returns (total, logs)."""
    ones = torch.ones(sent_emb.shape[0], device=sent_emb.device)
    total = 0.0
    feature_loss = 0.0
    logs: Dict[str, torch.Tensor] = {}
    for i, ((d_feat, d_cond, d_uncond), fake, real) in enumerate(
            zip(ds, fake_imgs, real_imgs)):
        features = d_feat(fake)
        loss = bce_on_sigmoid(d_cond(features, sent_emb), ones)
        if d_uncond is not None:
            loss = loss + bce_on_sigmoid(d_uncond(features), ones)
        total = total + loss
        logs[f"g_loss{i}"] = loss
        for r, f in zip(vgg_apply(real), vgg_apply(fake)):
            feature_loss = feature_loss + torch.mean((r - f) ** 2)
    wl, sl = _damsm_terms(image_encoder, fake_imgs[-1], sent_emb, words_embs, cap_lens,
                          class_ids, gammas)
    total = total + wl * smooth_lambda + sl * smooth_lambda + feature_loss / 3.0
    logs.update(w_loss=wl, s_loss=sl, vgg_feature_loss=feature_loss / 3.0)
    return total, logs


def dcm_generator_loss(d_feat: Callable, d_cond: Callable, d_uncond: Optional[Callable],
                       image_encoder: Callable, fake_img: torch.Tensor,
                       sent_emb: torch.Tensor, words_embs: torch.Tensor,
                       cap_lens: torch.Tensor, class_ids: Optional[torch.Tensor],
                       gammas=(4.0, 5.0, 10.0), smooth_lambda: float = 1.0):
    """= DCM_generator_loss (losses.py:668-704): one image's adversarial and
    DAMSM terms. Returns (total, {"g_loss", "w_loss", "s_loss"})."""
    ones = torch.ones(sent_emb.shape[0], device=sent_emb.device)
    features = d_feat(fake_img)
    g_loss = bce_on_sigmoid(d_cond(features, sent_emb), ones)
    if d_uncond is not None:
        g_loss = g_loss + bce_on_sigmoid(d_uncond(features), ones)
    wl, sl = _damsm_terms(image_encoder, fake_img, sent_emb, words_embs, cap_lens, class_ids,
                          gammas)
    total = g_loss + wl * smooth_lambda + sl * smooth_lambda
    return total, {"g_loss": g_loss, "w_loss": wl, "s_loss": sl}
