"""Word -> pixel cross-attention as a CUDA kernel (counterpart of
tgsr_tpu/ops/pallas_attention.py).

`word_pixel_attention` takes the JAX package's layout. On a CPU tensor it
runs the plain version (`ops/attention.py`); on a CUDA tensor it launches
`csrc/word_pixel_attention.cu` or raises. The kernel takes float32 or
bfloat16 (pixels and words in one dtype), computes the logits, the softmax
and ctx in float32, and returns ctx, and the attention map when
`return_attn` is set, in the inputs' dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tgsr_tpu_torch.ops import _build
from tgsr_tpu_torch.ops.attention import word_pixel_attention as plain_word_pixel_attention

NAME = "word_pixel_attention"
T_MAX = 32  # the kernel's register array (csrc/word_pixel_attention.cu TMAX)


def word_pixel_attention(
    pixels: torch.Tensor,  # [B, H, W, C] float32 or bfloat16
    words: torch.Tensor,  # [B, T, C] in pixels' dtype
    mask: Optional[torch.Tensor],  # [B, T] bool, True = padded
    return_attn: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (ctx [B, H, W, C], attn [B, T, H, W] or None)."""
    if pixels.device.type == "cpu":
        return plain_word_pixel_attention(pixels, words, mask, return_attn)
    if pixels.device.type != "cuda":
        raise ValueError(f"word_pixel_attention: no kernel for {pixels.device}")
    if pixels.dim() != 4 or words.dim() != 3:
        raise ValueError("word_pixel_attention: pixels [B,H,W,C], words [B,T,C]")
    b, h, w, c = pixels.shape
    t = words.shape[1]
    if tuple(words.shape) != (b, t, c) or not 1 <= t <= T_MAX:
        raise ValueError(f"word_pixel_attention: words {tuple(words.shape)} "
                         f"against pixels {tuple(pixels.shape)} (T <= {T_MAX})")
    tensors = [pixels, words]
    if mask is not None:
        if mask.dtype != torch.bool or tuple(mask.shape) != (b, t):
            raise ValueError("word_pixel_attention: mask must be bool [B, T]")
        tensors.append(mask)
    for x in tensors:
        if x.device != pixels.device or not x.is_contiguous():
            raise ValueError("word_pixel_attention: inputs must be contiguous "
                             "and on one device")
    if pixels.dtype not in _build.DTYPE_CODES or words.dtype != pixels.dtype:
        raise TypeError(f"word_pixel_attention: pixels {pixels.dtype}, words "
                        f"{words.dtype}; the kernel takes float32 or bfloat16, "
                        "both in one dtype")
    ctx = torch.empty_like(pixels)
    attn = (torch.empty((b, t, h, w), dtype=pixels.dtype, device=pixels.device)
            if return_attn else None)
    launch = _build.library(NAME).word_pixel_attention_launch
    with torch.cuda.device(pixels.device):
        err = launch(pixels.data_ptr(), words.data_ptr(),
                     mask.data_ptr() if mask is not None else None,
                     ctx.data_ptr(), attn.data_ptr() if attn is not None else None,
                     b, h * w, c, t, _build.DTYPE_CODES[pixels.dtype],
                     torch.cuda.current_stream().cuda_stream)
    _build.check(err, NAME)
    _build.LAUNCHES[NAME] += 1
    return ctx, attn
