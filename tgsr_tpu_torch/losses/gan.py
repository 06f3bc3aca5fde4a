"""GAN losses (counterpart of tgsr_tpu/losses/gan.py; = miscc/losses.py:290-424
the BCE-with-logits family, 428-580 the "or" family, 750-776 the
unconditional one, 813-883 the ESRGAN / relativistic one).

The discriminator comes in as closures per scale, as in the JAX package:
`d_features(img) -> features`, `d_cond(features, sent) -> [B] logits`,
`d_uncond(features) -> [B] logits` or None. The trainer's closures run the
port's `DNet` in train mode, so the call order below is the order in which
its BatchNorm running stats move. `generator_loss` adds the DAMSM word and
sentence terms when it is given an image encoder. The families after it are
library functions that no trainer calls, each JAX's with its swaps and
quirks (the docstrings say which); the port's `.detach()` stands for JAX's
`stop_gradient`.
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


def bce_on_sigmoid(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """= nn.BCELoss()(sigmoid(logits), targets), the "or" family's loss on a
    sigmoid-terminated D: with a logits D the computation of
    `bce_with_logits`, kept apart for the call sites (as JAX)."""
    return bce_with_logits(logits, targets)


def bce_on_probs(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """= nn.BCELoss() on `probs` as they are, its logs floored at -100, as
    torch's. The relativistic family feeds it a difference of sigmoids;
    torch raises outside [0, 1], JAX's and this give NaN there."""
    logp = torch.clamp(torch.log(probs), min=-100.0)
    log1mp = torch.clamp(torch.log(1.0 - probs), min=-100.0)
    return -torch.mean(targets * logp + (1.0 - targets) * log1mp)


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
                   g: float = 1.0, word_scale: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """= generator_loss (losses.py:351-391): per scale the cond (+ uncond)
    BCE against ones, times g; with an `image_encoder` (fake image ->
    (region features [B, R, E], code [B, E])) on the finest fake, the DAMSM
    words loss times w and the sentence loss times s, both times
    `smooth_lambda`; `word_scale` [B, T] reweights the words of the words
    loss (generator_re_weight_loss, losses.py:318-350). Returns (total,
    {"g_loss{i}": ..., "w_loss", "s_loss"})."""
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
        w0, w1, _ = words_loss(region_features, words_embs, cap_lens, class_ids, *gammas,
                               word_scale=word_scale)
        s0, s1 = sent_loss(cnn_code, sent_emb, class_ids, gammas[2])
        logs["w_loss"] = w * (w0 + w1) * smooth_lambda
        logs["s_loss"] = s * (s0 + s1) * smooth_lambda
        total = total + logs["w_loss"] + logs["s_loss"]
    return total, logs


def _damsm_terms(image_encoder: Callable, fake: torch.Tensor, sent_emb: torch.Tensor,
                 words_embs: torch.Tensor, cap_lens: torch.Tensor,
                 class_ids: Optional[torch.Tensor], gammas: Tuple[float, float, float]):
    """(w0 + w1, s0 + s1) of the DAMSM words and sentence losses on `fake`."""
    region_features, cnn_code = image_encoder(fake)
    w0, w1, _ = words_loss(region_features, words_embs, cap_lens, class_ids, *gammas)
    s0, s1 = sent_loss(cnn_code, sent_emb, class_ids, gammas[2])
    return w0 + w1, s0 + s1


def generator_loss_oneim(ds_last: DClosures, image_encoder: Optional[Callable],
                         fake_imgs: Sequence[torch.Tensor], sent_emb: torch.Tensor,
                         words_embs=None, cap_lens=None, class_ids=None,
                         gammas=(4.0, 5.0, 10.0), smooth_lambda: float = 1.0):
    """= generator_loss_oneim (losses.py:392-424): the finest scale only."""
    return generator_loss([ds_last], image_encoder, [fake_imgs[-1]], sent_emb, words_embs,
                          cap_lens, class_ids, gammas, smooth_lambda)


# -- the "or" family (sigmoid-terminated D and plain BCE), losses.py:428-580 --

def discriminator_loss_sigmoid(*args, **kwargs) -> torch.Tensor:
    """= discriminator_lossor (losses.py:428-452): `discriminator_loss` on a
    logits D."""
    return discriminator_loss(*args, **kwargs)


def generator_loss_sigmoid(ds, image_encoder, fake_imgs, sent_emb, words_embs, cap_lens,
                           class_ids, gammas=(4.0, 5.0, 10.0), smooth_lambda: float = 1.0,
                           w: float = 1.0, s: float = 1.0, g: float = 1.0):
    """= generator_lossor (losses.py:455-496): w == 0 or s == 0 drops the
    DAMSM terms (the reference's `(s != 0) and (w != 0)` gate)."""
    enc = image_encoder if (w != 0 and s != 0) else None
    return generator_loss(ds, enc, fake_imgs, sent_emb, words_embs, cap_lens, class_ids,
                          gammas, smooth_lambda, w, s, g)


def generator_loss_wordsent_only(image_encoder, fake_imgs, sent_emb, words_embs, cap_lens,
                                 class_ids, gammas=(4.0, 5.0, 10.0),
                                 smooth_lambda: float = 1.0, w: float = 1.0, s: float = 1.0):
    """= generator_lossor_wordsentOnly (losses.py:499-522): the DAMSM terms
    alone; the logs carry them without smooth_lambda, as JAX's."""
    wl, sl = _damsm_terms(image_encoder, fake_imgs[-1], sent_emb, words_embs, cap_lens,
                          class_ids, gammas)
    total = w * wl * smooth_lambda + s * sl * smooth_lambda
    return total, {"w_loss": w * wl, "s_loss": s * sl}


def generator_loss_no_wordsent(ds, fake_imgs, sent_emb, g: float = 1.0):
    """= generator_lossor_nowordsent (losses.py:525-545): the adversarial
    terms alone."""
    return generator_loss(ds, None, fake_imgs, sent_emb, g=g)


def generator_loss_face(ds, image_encoder, fake_imgs, sent_emb, words_embs, cap_lens,
                        class_ids, gammas=(4.0, 5.0, 10.0), smooth_lambda: float = 1.0,
                        w: float = 1.0, s: float = 1.0, g: Optional[Sequence[float]] = None):
    """= generator_lossorface (losses.py:548-580): a weight g[i] per scale
    (1 each by default); the logs carry each scale's loss before its weight
    and the DAMSM terms before w, s and smooth_lambda, as JAX's."""
    g = [1.0] * len(ds) if g is None else g
    ones = torch.ones(sent_emb.shape[0], device=sent_emb.device)
    total = 0.0
    logs: Dict[str, torch.Tensor] = {}
    for i, ((d_feat, d_cond, d_uncond), fake) in enumerate(zip(ds, fake_imgs)):
        features = d_feat(fake)
        loss = bce_on_sigmoid(d_cond(features, sent_emb), ones)
        if d_uncond is not None:
            loss = loss + bce_on_sigmoid(d_uncond(features), ones)
        total = total + g[i] * loss
        logs[f"g_loss{i}"] = loss
    wl, sl = _damsm_terms(image_encoder, fake_imgs[-1], sent_emb, words_embs, cap_lens,
                          class_ids, gammas)
    total = total + w * wl * smooth_lambda + s * sl * smooth_lambda
    logs["w_loss"], logs["s_loss"] = wl, sl
    return total, logs


# -- the unconditional family, losses.py:750-776 ------------------------------

def generator_loss_uncond(ds, fake_imgs):
    """= generator_lossor_Uncond (losses.py:750-762): each scale's
    unconditional head against ones."""
    total = 0.0
    logs: Dict[str, torch.Tensor] = {}
    for i, ((d_feat, _, d_uncond), fake) in enumerate(zip(ds, fake_imgs)):
        ones = torch.ones(fake.shape[0], device=fake.device)
        loss = bce_on_sigmoid(d_uncond(d_feat(fake)), ones)
        total = total + loss
        logs[f"uncond_g_loss{i}"] = loss
    return total, logs


def discriminator_loss_uncond(d_features, d_uncond, real_imgs, fake_imgs) -> torch.Tensor:
    """= discriminator_lossor_Uncond (losses.py:765-776): real against ones,
    the detached fakes against zeros."""
    b = real_imgs.shape[0]
    real_logits = d_uncond(d_features(real_imgs))
    fake_logits = d_uncond(d_features(fake_imgs.detach()))
    return (bce_on_sigmoid(real_logits, torch.ones(b, device=real_imgs.device))
            + bce_on_sigmoid(fake_logits, torch.zeros(b, device=real_imgs.device)))


# -- the ESRGAN relativistic family, losses.py:813-883 -------------------------

def esrgan_g_loss(d_apply: Callable, fake_imgs: torch.Tensor,
                  real_imgs: torch.Tensor) -> torch.Tensor:
    """= ESRGAN_loss (losses.py:814-829), the reference's swap kept: pred_real
    = D(fake.detach()), pred_fake = D(real), BCE(pred_fake - pred_real, 1);
    so G's gradient reaches it through no fake image."""
    b = fake_imgs.shape[0]
    pred_real = d_apply(fake_imgs.detach())
    pred_fake = d_apply(real_imgs)
    return bce_with_logits(pred_fake - pred_real, torch.ones(b, device=fake_imgs.device))


def esrgan_d_loss(d_apply: Callable, real_imgs: torch.Tensor,
                  fake_imgs: torch.Tensor) -> torch.Tensor:
    """= ESRGAND_loss (losses.py:832-849): the relativistic average GAN's D
    loss on the detached fakes."""
    b = real_imgs.shape[0]
    pred_fake = d_apply(fake_imgs.detach())
    pred_real = d_apply(real_imgs)
    ones = torch.ones(b, device=real_imgs.device)
    loss_real = bce_with_logits(pred_real - pred_fake.mean(dim=0, keepdim=True), ones)
    loss_fake = bce_with_logits(pred_fake - pred_real.mean(dim=0, keepdim=True), ones * 0)
    return (loss_real + loss_fake) / 2.0


def relativistic_g_loss(d_feat, d_uncond, fake_imgs, real_imgs) -> torch.Tensor:
    """= generator_EGAN_loss (losses.py:852-868): BCE on the difference of
    the sigmoid outputs, the fakes detached as the reference's (losses.py:857,
    so no gradient reaches G); NaN where sigmoid(fake) <= sigmoid(real)
    (torch raises there)."""
    b = fake_imgs.shape[0]
    p_fake = torch.sigmoid(d_uncond(d_feat(fake_imgs.detach())))
    p_real = torch.sigmoid(d_uncond(d_feat(real_imgs)))
    return bce_on_probs(p_fake - p_real, torch.ones(b, device=fake_imgs.device))


def relativistic_d_loss(d_feat, d_uncond, real_imgs, fake_imgs) -> torch.Tensor:
    """= discriminator_EGAND_loss (losses.py:871-883). Since the two
    centred differences sum to 0, some BCE input is <= 0 unless every
    prediction is equal: the reference raises in any such regime, JAX and
    this give NaN."""
    b = real_imgs.shape[0]
    p_fake = torch.sigmoid(d_uncond(d_feat(fake_imgs.detach())))
    p_real = torch.sigmoid(d_uncond(d_feat(real_imgs)))
    ones = torch.ones(b, device=real_imgs.device)
    loss_real = bce_on_probs(p_real - p_fake.mean(dim=0, keepdim=True), ones)
    loss_fake = bce_on_probs(p_fake - p_real.mean(dim=0, keepdim=True), ones * 0)
    return (loss_real + loss_fake) / 2.0
