"""DAMSM contrastive losses, batched (counterpart of tgsr_tpu/losses/damsm.py;
= miscc/losses.py:12-136 and the similarity-only variants :234-287).

The reference loops over the captions of a batch in Python (losses.py:73-113);
the JAX package maps one caption at a time over every image with `vmap`.
Here every (caption, image) pair is one broadcast batch of `func_attention`:
the affinities [B, B, R, T] are one GEMM of all words against all regions.
The masking is the JAX package's: padded words are dropped from the Eq. 8
softmax over words and from the Eq. 10 log-sum-exp. Only caption i's
attention over image i leaves the function ([B, T, R]), as in JAX.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tgsr_tpu_torch.ops.attention import NEG_INF, func_attention


def cosine_similarity(x1: torch.Tensor, x2: torch.Tensor, dim: int = -1,
                      eps: float = 1e-8) -> torch.Tensor:
    """= losses.py:12-18: <x1, x2> / max(|x1| |x2|, eps)."""
    w12 = torch.sum(x1 * x2, dim=dim)
    w1 = torch.linalg.vector_norm(x1, dim=dim)
    w2 = torch.linalg.vector_norm(x2, dim=dim)
    return w12 / torch.clamp(w1 * w2, min=eps)


def _class_mask(class_ids: Optional[torch.Tensor], batch: int) -> Optional[torch.Tensor]:
    """mask[i, j] True where class_ids[j] == class_ids[i] and j != i: the
    same-class negatives the reference leaves out (losses.py:24-34)."""
    if class_ids is None:
        return None
    class_ids = torch.as_tensor(class_ids)
    eq = class_ids[:, None] == class_ids[None, :]
    return eq & ~torch.eye(batch, dtype=torch.bool, device=eq.device)


def _symmetric_ce(scores: torch.Tensor, mask: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy over the rows of scores and of scores.T, the labels on
    the diagonal."""
    if mask is not None:
        scores = scores.masked_fill(mask.to(scores.device), NEG_INF)
    loss0 = -torch.log_softmax(scores, dim=-1).diagonal().mean()
    loss1 = -torch.log_softmax(scores.t(), dim=-1).diagonal().mean()
    return loss0, loss1


def sent_similarity(cnn_code: torch.Tensor, rnn_code: torch.Tensor, gamma3: float = 10.0,
                    eps: float = 1e-8) -> torch.Tensor:
    """= losses.py:234-250: gamma3 times the cosine of every image code
    [B, E] with every sentence [B, E] -> [image, sentence]."""
    norm_c = torch.linalg.vector_norm(cnn_code, dim=-1, keepdim=True)
    norm_r = torch.linalg.vector_norm(rnn_code, dim=-1, keepdim=True)
    return (cnn_code @ rnn_code.t()) / torch.clamp(norm_c @ norm_r.t(), min=eps) * gamma3


def sent_loss(cnn_code: torch.Tensor, rnn_code: torch.Tensor,
              class_ids: Optional[torch.Tensor], gamma3: float = 10.0,
              eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """= losses.py:21-62: the gamma3-scaled cosine scores, same-class
    negatives masked, symmetric cross-entropy. Returns (loss0, loss1)."""
    scores = sent_similarity(cnn_code, rnn_code, gamma3, eps)
    return _symmetric_ce(scores, _class_mask(class_ids, cnn_code.shape[0]))


def _words_similarity_matrix(img_features: torch.Tensor, words_emb: torch.Tensor,
                             cap_lens: torch.Tensor, gamma1: float, gamma2: float,
                             word_scale: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """similarities[image j, caption i] (Eq. 10, the inner loop of
    losses.py:73-116) and the diagonal attention maps [B, T, R].

    img_features [B, R, E], words_emb [B, T, E], cap_lens [B];
    `word_scale` [B, T] reweights the words (losses.py:137-232)."""
    t = words_emb.shape[1]
    cap_lens = torch.as_tensor(cap_lens, device=words_emb.device)
    word_mask = torch.arange(t, device=words_emb.device)[None, :] >= cap_lens[:, None]
    if word_scale is not None:
        words_emb = words_emb * word_scale[:, :, None]
    # caption i (axis 0) against image j (axis 1)
    words = words_emb[:, None]  # [B, 1, T, E]
    ctx, attn = func_attention(words, img_features[None], gamma1,
                               word_mask=word_mask[:, None])  # [B, B, T, E], [B, B, T, R]
    sim = cosine_similarity(words, ctx)  # [B, B, T]
    sim = (sim * gamma2).masked_fill(word_mask[:, None, :], NEG_INF)
    cols = torch.logsumexp(sim, dim=-1)  # [caption, image]
    diag_attn = attn.diagonal(dim1=0, dim2=1).permute(2, 0, 1)  # [B, T, R]
    return cols.t(), diag_attn


def words_loss(img_features: torch.Tensor, words_emb: torch.Tensor, cap_lens: torch.Tensor,
               class_ids: Optional[torch.Tensor], gamma1: float = 4.0, gamma2: float = 5.0,
               gamma3: float = 10.0, word_scale: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """= losses.py:65-136 (and the reweighted variant through `word_scale`).
    Returns (loss0, loss1, attn_maps [B, T, R])."""
    sims, attn = _words_similarity_matrix(img_features, words_emb, cap_lens, gamma1, gamma2,
                                          word_scale)
    loss0, loss1 = _symmetric_ce(sims * gamma3, _class_mask(class_ids, img_features.shape[0]))
    return loss0, loss1, attn


def words_similarity(img_features: torch.Tensor, words_emb: torch.Tensor,
                     cap_lens: torch.Tensor, gamma1: float = 4.0,
                     gamma2: float = 5.0) -> torch.Tensor:
    """= losses.py:251-287: the [image, caption] word-level similarities."""
    return _words_similarity_matrix(img_features, words_emb, cap_lens, gamma1, gamma2)[0]


def word_confidence_scores(attn_maps: torch.Tensor, cap_lens: torch.Tensor) -> torch.Tensor:
    """Per-word confidence from the generator's attention maps (= losses.py
    :151-163): the attention mass above 2 * (2 / len). attn_maps [B, T, H, W]
    -> [B, T]."""
    lens = torch.as_tensor(cap_lens, device=attn_maps.device).to(torch.float32)
    thresh = 2.0 / torch.clamp(lens, min=1.0)
    m = (attn_maps > (2.0 * thresh)[:, None, None, None]).to(attn_maps.dtype)
    return torch.sum(attn_maps * m, dim=(2, 3))
