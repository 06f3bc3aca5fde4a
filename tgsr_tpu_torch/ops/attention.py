"""The two attentions of the reference, plain PyTorch (counterpart of
tgsr_tpu/ops/attention.py).

`word_pixel_attention` here is the plain version of the CUDA kernel in
`ops/fused_attention.py`: the CPU path and the reference the kernel is held
against. Layouts are the JAX package's: pixels [B, H, W, C], words
[B, T, C], mask [B, T] (True = padded token), attention maps [B, T, H, W].

`func_attention` is DAMSM's word -> region attention (Eq. 7-9), which the
words loss runs. JAX computes it with einsums outside any Pallas kernel, and
so does the port: `torch.einsum` on the card is cuBLAS's batched GEMM.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tgsr_tpu_torch.ops.blocks import nchw, nhwc

NEG_INF = -1e9  # finite sentinel, as in the JAX package


def masked_softmax(logits: torch.Tensor, mask: Optional[torch.Tensor],
                   dim: int = -1) -> torch.Tensor:
    """Softmax with `mask == True` positions filled with -1e9 first (a
    where-fill: an all-padded row gives a uniform distribution)."""
    if mask is not None:
        logits = logits.masked_fill(mask, NEG_INF)
    return torch.softmax(logits, dim=dim)


def func_attention(
    words: torch.Tensor,  # [..., T, E] word features
    regions: torch.Tensor,  # [..., R, E] image region features (R = 17 * 17)
    gamma1: float,
    word_mask: Optional[torch.Tensor] = None,  # [..., T] True where padded
) -> Tuple[torch.Tensor, torch.Tensor]:
    """DAMSM attention (= GlobalAttention.py:33-74): for each region a
    softmax over the unpadded words (Eq. 8), then, sharpened by gamma1, for
    each word a softmax over the regions (Eq. 9); the context of word t is
    sum_r attn[t, r] * regions[r]. Any leading batch axes broadcast (the
    words loss pairs every caption with every image this way).

    Returns (context [..., T, E], attn [..., T, R])."""
    attn = torch.einsum("...re,...te->...rt", regions, words)  # Eq. 7
    m = word_mask.unsqueeze(-2) if word_mask is not None else None
    attn = masked_softmax(attn, m, dim=-1)
    attn = torch.softmax(attn.transpose(-1, -2) * gamma1, dim=-1)
    ctx = torch.einsum("...tr,...re->...te", attn, regions)
    return ctx, attn


def word_pixel_attention(
    pixels: torch.Tensor,  # [B, H, W, C]
    words: torch.Tensor,  # [B, T, C] projected word embeddings
    mask: Optional[torch.Tensor],  # [B, T] bool, True = padded
    return_attn: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """attn[p, t] = softmax_t(<pixel_p, word_t>) over the sample's own
    unpadded words; ctx_p = sum_t attn[p, t] * word_t.

    Each sample gets its own mask: the reference's batch > 1 mask tiling
    gives pixel rows another sample's mask, and the JAX package fixes that
    deliberately (tgsr_tpu/ops/attention.py word_pixel_attention).

    In bfloat16 it computes as the JAX XLA path does: the products in
    bfloat16, the where-fill softmax on bfloat16 logits.

    Returns (ctx [B, H, W, C], attn [B, T, H, W] or None), in pixels' dtype."""
    logits = torch.einsum("bhwc,btc->bhwt", pixels, words)
    m = mask[:, None, None, :] if mask is not None else None
    attn = masked_softmax(logits, m, dim=-1)
    ctx = torch.einsum("bhwt,btc->bhwc", attn, words)
    return ctx, (attn.permute(0, 3, 1, 2).contiguous() if return_attn else None)


class WordPixelAttention(nn.Module):
    """= GlobalAttentionGeneral(idf, cdf) (GlobalAttention.py:77-130): a
    bias-free 1x1 `conv_context` projects words cdf -> idf, then pixels
    attend to words, through the CUDA kernel on the card."""

    def __init__(self, idf: int, cdf: int):
        super().__init__()
        self.conv_context = nn.Conv2d(cdf, idf, 1, bias=False)

    def forward(self, pixels: torch.Tensor, words: torch.Tensor,
                mask: Optional[torch.Tensor], need_attn: bool = False):
        """pixels NCHW, words [B, T, cdf] -> (ctx NCHW, attn or None)."""
        from tgsr_tpu_torch.ops import fused_attention

        words_proj = F.linear(words, self.conv_context.weight.flatten(1))
        ctx, attn = fused_attention.word_pixel_attention(
            nhwc(pixels), words_proj.contiguous(), mask, return_attn=need_attn)
        return nchw(ctx), attn


def word_region_attention(*args, **kwargs):
    """Alias of `func_attention` (the DAMSM loss's name for it)."""
    return func_attention(*args, **kwargs)


class WordPixelAttentionWeighted(nn.Module):
    """= GlobalAttentionGeneral_weight (GlobalAttention.py:135-185; JAX's
    WordPixelAttentionWeighted, tgsr_tpu/ops/attention.py:142-164): the
    attention of `WordPixelAttention`, whose per-word mass averaged over the
    pixels rescales the projected words before the value product. Plain
    torch on every device, as JAX computes it with einsums outside any
    Pallas kernel: the value operand is words_proj * mean_pixels(attn), not
    the projected words that row 1's kernel reads."""

    def __init__(self, idf: int, cdf: int):
        super().__init__()
        self.conv_context = nn.Conv2d(cdf, idf, 1, bias=False)

    def forward(self, pixels: torch.Tensor, words: torch.Tensor,
                mask: Optional[torch.Tensor], need_attn: bool = False):
        """pixels NCHW, words [B, T, cdf] -> (ctx NCHW, attn [B, T, H, W] or
        None)."""
        words_proj = F.linear(words, self.conv_context.weight.flatten(1))
        logits = torch.einsum("bchw,btc->bhwt", pixels, words_proj)
        m = mask[:, None, None, :] if mask is not None else None
        attn = masked_softmax(logits, m, dim=-1)  # [B, H, W, T]
        words_w = words_proj * attn.mean(dim=(1, 2))[:, :, None]  # [B, T, idf]
        ctx = torch.einsum("bhwt,btc->bchw", attn, words_w)
        return ctx, (attn.permute(0, 3, 1, 2).contiguous() if need_attn else None)
