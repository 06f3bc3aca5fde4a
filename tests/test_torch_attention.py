"""Word -> pixel attention of tgsr_tpu_torch against tgsr_tpu, f32 on the CPU.

The port's plain version (which its wrapper runs for CPU tensors) is held
against the JAX XLA einsum path and against the JAX Pallas kernel in
interpret mode, as tests/test_pallas_attention.py runs it. Gate
rtol = atol = 1e-5, that test's: two T <= 18 sums in another order. The CUDA
kernel is held against the plain version on the card in
tests/test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgsr_tpu.ops.attention import WordPixelAttention as JWordPixelAttention
from tgsr_tpu.ops.attention import word_pixel_attention as jax_wpa
from tgsr_tpu.ops.pallas_attention import word_pixel_attention_pallas
from tgsr_tpu_torch.ops.attention import WordPixelAttention, masked_softmax
from tgsr_tpu_torch.ops.attention import word_pixel_attention as plain_wpa
from tgsr_tpu_torch.ops.fused_attention import word_pixel_attention

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(b, h, w, c, t, lens, seed=0):
    rng = np.random.default_rng(seed)
    px = rng.normal(size=(b, h, w, c)).astype(np.float32)
    wd = rng.normal(size=(b, t, c)).astype(np.float32)
    mask = np.arange(t)[None, :] >= np.asarray(lens)[:, None]
    return px, wd, mask


def _port(px, wd, mask, fn=word_pixel_attention):
    ctx, attn = fn(torch.from_numpy(px), torch.from_numpy(wd),
                   torch.from_numpy(mask))
    return ctx.numpy(), attn.numpy()


@pytest.mark.parametrize("shape,lens", [
    ((2, 8, 8, 8, 6), [6, 3]),        # mixed caption lengths
    ((3, 16, 16, 32, 18), [18, 12, 1]),
])
def test_plain_matches_xla(shape, lens):
    b, h, w, c, t = shape
    px, wd, mask = _inputs(b, h, w, c, t, lens)
    ctx_r, attn_r = jax_wpa(jnp.asarray(px), jnp.asarray(wd), jnp.asarray(mask))
    for fn in (plain_wpa, word_pixel_attention):  # wrapper on CPU = plain
        ctx, attn = _port(px, wd, mask, fn)
        np.testing.assert_allclose(ctx, np.asarray(ctx_r), **TOL)
        np.testing.assert_allclose(attn, np.asarray(attn_r), **TOL)


@pytest.mark.parametrize("shape,lens", [
    ((2, 32, 32, 32, 18), [12, 18]),
    ((1, 64, 64, 32, 18), [5]),
])
def test_plain_matches_pallas_interpret(shape, lens):
    b, h, w, c, t = shape
    px, wd, mask = _inputs(b, h, w, c, t, lens, seed=1)
    ctx_r, attn_r = word_pixel_attention_pallas(
        jnp.asarray(px), jnp.asarray(wd), jnp.asarray(mask))
    ctx, attn = _port(px, wd, mask)
    np.testing.assert_allclose(ctx, np.asarray(ctx_r), **TOL)
    np.testing.assert_allclose(attn, np.asarray(attn_r), **TOL)


def test_all_padded_caption_where_fill():
    """A caption with every token padded. Held against the XLA path only:
    the port pins the where-fill of tgsr_tpu.ops.attention.masked_softmax
    (uniform 1/T over the row), while the Pallas kernel adds mask * -1e9,
    which rounds the logits differently in float32 for such a row."""
    px, wd, mask = _inputs(2, 8, 8, 16, 6, [0, 4], seed=2)
    ctx_r, attn_r = jax_wpa(jnp.asarray(px), jnp.asarray(wd), jnp.asarray(mask))
    ctx, attn = _port(px, wd, mask)
    np.testing.assert_allclose(attn[0], np.full_like(attn[0], 1 / 6), **TOL)
    np.testing.assert_allclose(ctx, np.asarray(ctx_r), **TOL)
    np.testing.assert_allclose(attn, np.asarray(attn_r), **TOL)


def test_batch_row_equals_single():
    """Each sample uses its own mask: row 0 of a mixed-length batch equals
    the B = 1 result."""
    px, wd, mask = _inputs(2, 8, 8, 8, 6, [2, 6], seed=3)
    ctx2, attn2 = _port(px, wd, mask)
    ctx1, attn1 = _port(px[:1], wd[:1], mask[:1])
    np.testing.assert_allclose(ctx2[:1], ctx1, rtol=0, atol=1e-6)
    np.testing.assert_allclose(attn2[:1], attn1, rtol=0, atol=1e-6)


def test_masked_softmax_fill():
    logits = torch.tensor([[1.0, 2.0, 3.0]])
    mask = torch.tensor([[False, True, False]])
    p = masked_softmax(logits, mask)
    assert p[0, 1] < 1e-30
    np.testing.assert_allclose(p.sum().item(), 1.0, rtol=1e-6)


def test_module_matches_jax_module():
    """WordPixelAttention with conv_context carried across as [idf, cdf, 1, 1]."""
    b, h, w, idf, cdf, t = 2, 8, 8, 8, 32, 6
    rng = np.random.default_rng(4)
    px = rng.normal(size=(b, h, w, idf)).astype(np.float32)
    words = rng.normal(size=(b, t, cdf)).astype(np.float32)
    mask = np.arange(t)[None, :] >= np.array([[6], [2]])
    jm = JWordPixelAttention(idf)
    v = jm.init(jax.random.PRNGKey(0), px, words, mask)
    ctx_r, attn_r = jm.apply(v, px, words, mask)

    m = WordPixelAttention(idf, cdf)
    kernel = np.asarray(v["params"]["conv_context"]["kernel"])  # [cdf, idf]
    m.conv_context.weight.data = torch.from_numpy(kernel.T.copy())[:, :, None, None]
    with torch.no_grad():
        ctx, attn = m(torch.from_numpy(px).permute(0, 3, 1, 2),
                      torch.from_numpy(words), torch.from_numpy(mask),
                      need_attn=True)
    np.testing.assert_allclose(ctx.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ctx_r), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(attn.numpy(), np.asarray(attn_r),
                               rtol=1e-4, atol=1e-5)


def test_wrapper_has_no_path_for_other_devices():
    """CPU tensors take the plain version; any device but CUDA raises."""
    px = torch.empty(1, 4, 4, 8, device="meta")
    wd = torch.empty(1, 6, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        word_pixel_attention(px, wd, None)
