"""Word -> pixel cross-attention as a CUDA kernel (counterpart of
tgsr_tpu/ops/pallas_attention.py).

`word_pixel_attention` takes the JAX package's layout and calls the custom
op `tgsr::word_pixel_attention` (`ops/library.py`), whose CPU implementation
is the plain version (`ops/attention.py`) and whose CUDA implementation
launches `csrc/word_pixel_attention.cu` or raises. The kernel takes float32
or bfloat16 (pixels and words in one dtype), computes the logits, the
softmax and ctx in float32, and returns ctx, and the attention map when
`return_attn` is set, in the inputs' dtype. The op always returns two
tensors (a custom op has no optional output): the map, or an empty tensor.

Where autograd needs a gradient (grad mode on and pixels or words requiring
one), a CPU call runs the plain version, which autograd differentiates, and
a CUDA call goes through `_KernelAttention`, a `torch.autograd.Function`
over two ops: its forward is the same op, its backward the op
`tgsr::word_pixel_attention_bwd`, the kernel's backward in the same source
(recomputes the softmax per pixel tile, writes dpixels, and sums dwords
over the tiles in a second launch). Under `torch.no_grad()`, in graph
capture and in an exported program the forward op runs alone, as serving
always has.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tgsr_tpu_torch.ops import _build
from tgsr_tpu_torch.ops.attention import word_pixel_attention as plain_word_pixel_attention

NAME = "word_pixel_attention"
BWD_NAME = "word_pixel_attention_bwd"
T_MAX = 32  # the kernel's register array (csrc/word_pixel_attention.cu TMAX)
C_MAX = 128  # the kernel's pixel tile fits in shared memory up to here


def _check(pixels: torch.Tensor, words: torch.Tensor, mask: Optional[torch.Tensor]) -> None:
    """Raises on what the kernel does not take."""
    if pixels.dim() != 4 or words.dim() != 3:
        raise ValueError("word_pixel_attention: pixels [B,H,W,C], words [B,T,C]")
    b, _, _, c = pixels.shape
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
    # the kernel moves pixels and ctx 16 bytes at a time and indexes a
    # pixel's 16-byte pieces by shift and mask
    pieces = c * pixels.element_size() // 16
    if c * pixels.element_size() % 16 or pieces & (pieces - 1) or c > C_MAX:
        raise ValueError(f"word_pixel_attention: C {c} in {pixels.dtype} must be 16 bytes "
                         f"times a power of two, and at most {C_MAX}")
    if pixels.data_ptr() % 16:
        raise ValueError("word_pixel_attention: pixels must be 16-byte aligned")


def _launch(pixels, words, mask, return_attn: bool):
    b, h, w, c = pixels.shape
    t = words.shape[1]
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


def _attn_shape(pixels: torch.Tensor, words: torch.Tensor, return_attn: bool) -> tuple:
    b, h, w, _ = pixels.shape
    return (b, words.shape[1], h, w) if return_attn else (0,)


@torch.library.custom_op("tgsr::word_pixel_attention", mutates_args=(), device_types="cuda")
def _attention_op(pixels: torch.Tensor, words: torch.Tensor, mask: Optional[torch.Tensor],
                  return_attn: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(pixels, words, mask)
    ctx, attn = _launch(pixels, words, mask, return_attn)
    return ctx, attn if attn is not None else pixels.new_empty(0)


@_attention_op.register_kernel("cpu")
def _(pixels, words, mask, return_attn):
    ctx, attn = plain_word_pixel_attention(pixels, words, mask, return_attn)
    return ctx.contiguous(), attn if attn is not None else pixels.new_empty(0)


@_attention_op.register_fake
def _(pixels, words, mask, return_attn):
    return pixels.new_empty(pixels.shape), pixels.new_empty(_attn_shape(pixels, words,
                                                                        return_attn))


@torch.library.custom_op("tgsr::word_pixel_attention_bwd", mutates_args=(),
                         device_types="cuda")
def _attention_bwd_op(pixels: torch.Tensor, words: torch.Tensor, mask: Optional[torch.Tensor],
                      grad_ctx: torch.Tensor, grad_attn: Optional[torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, h, w, c = pixels.shape
    t = words.shape[1]
    lib = _build.library(NAME)
    dpixels = torch.empty_like(pixels)
    dwords = torch.empty_like(words)
    ws = torch.empty(lib.word_pixel_attention_bwd_workspace(b, h * w, c, t) // 4,
                     dtype=torch.float32, device=pixels.device)
    with torch.cuda.device(pixels.device):
        err = lib.word_pixel_attention_bwd_launch(
            pixels.data_ptr(), words.data_ptr(), mask.data_ptr() if mask is not None else None,
            grad_ctx.data_ptr(), grad_attn.data_ptr() if grad_attn is not None else None,
            dpixels.data_ptr(), dwords.data_ptr(), ws.data_ptr(), b, h * w, c, t,
            _build.DTYPE_CODES[pixels.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(err, BWD_NAME)
    _build.LAUNCHES[BWD_NAME] += 1
    return dpixels, dwords


@_attention_bwd_op.register_kernel("cpu")
def _(pixels, words, mask, grad_ctx, grad_attn):
    """The plain version's gradient, by autograd."""
    with torch.enable_grad():
        p, wd = pixels.detach().requires_grad_(), words.detach().requires_grad_()
        ctx, attn = plain_word_pixel_attention(p, wd, mask, grad_attn is not None)
        outs, grads = [ctx], [grad_ctx]
        if grad_attn is not None:
            outs.append(attn)
            grads.append(grad_attn)
        dp, dw = torch.autograd.grad(outs, (p, wd), grads)
    return dp.contiguous(), dw.contiguous()


@_attention_bwd_op.register_fake
def _(pixels, words, mask, grad_ctx, grad_attn):
    return pixels.new_empty(pixels.shape), words.new_empty(words.shape)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous and 16-byte aligned (a copy only where it is not)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def word_pixel_attention_bwd(pixels: torch.Tensor, words: torch.Tensor,
                             mask: Optional[torch.Tensor], grad_ctx: torch.Tensor,
                             grad_attn: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel: (dpixels [B, H, W, C], dwords [B, T, C]) in the
    inputs' dtype, from grad_ctx [B, H, W, C] and grad_attn [B, T, H, W] (or
    None), both in the inputs' dtype. CUDA tensors only."""
    _check(pixels, words, mask)
    b, h, w, c = pixels.shape
    t = words.shape[1]
    grad_ctx = _aligned(grad_ctx.to(pixels.dtype))
    if tuple(grad_ctx.shape) != tuple(pixels.shape) or grad_ctx.device != pixels.device:
        raise ValueError("word_pixel_attention_bwd: grad_ctx must match pixels")
    if grad_attn is not None:
        grad_attn = grad_attn.to(pixels.dtype).contiguous()
        if tuple(grad_attn.shape) != (b, t, h, w) or grad_attn.device != pixels.device:
            raise ValueError("word_pixel_attention_bwd: grad_attn must be [B, T, H, W]")
    return torch.ops.tgsr.word_pixel_attention_bwd(pixels, words, mask, grad_ctx, grad_attn)


class _KernelAttention(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient. Saves
    only the inputs: the backward recomputes the softmax."""

    @staticmethod
    def forward(ctx, pixels, words, mask, return_attn):
        out, attn = torch.ops.tgsr.word_pixel_attention(pixels, words, mask, return_attn)
        ctx.save_for_backward(pixels, words, mask)
        ctx.set_materialize_grads(False)
        return (out, attn) if return_attn else out

    @staticmethod
    def backward(ctx, grad_ctx, grad_attn=None):
        pixels, words, mask = ctx.saved_tensors
        if grad_ctx is None:
            grad_ctx = torch.zeros_like(pixels)
        dpixels, dwords = word_pixel_attention_bwd(pixels, words, mask, grad_ctx, grad_attn)
        return dpixels, dwords, None, None


def word_pixel_attention(
    pixels: torch.Tensor,  # [B, H, W, C] float32 or bfloat16
    words: torch.Tensor,  # [B, T, C] in pixels' dtype
    mask: Optional[torch.Tensor],  # [B, T] bool, True = padded
    return_attn: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (ctx [B, H, W, C], attn [B, T, H, W] or None)."""
    _build.check_device(pixels, "word_pixel_attention")
    if torch.is_grad_enabled() and (pixels.requires_grad or words.requires_grad):
        if pixels.device.type == "cpu":
            return plain_word_pixel_attention(pixels, words, mask, return_attn)
        _check(pixels, words, mask)
        out = _KernelAttention.apply(pixels, words, mask, return_attn)
        return out if return_attn else (out, None)
    ctx, attn = torch.ops.tgsr.word_pixel_attention(pixels, words, mask, return_attn)
    return ctx, attn if return_attn else None
