"""Gradients of word -> pixel attention: the port's plain version (what its
wrapper runs, and autograd differentiates, on CPU tensors) against
`jax.grad` of tgsr_tpu.ops.attention.word_pixel_attention (XLA's autodiff
of the einsum path, which the JAX trainer differentiates) on the CPU; and the
serving-only kernel wrappers refusing to run where autograd would need a
gradient they cannot give.

The loss is sum(ctx * g) (+ sum(attn * ga)), g and ga from a numpy seed;
ragged captions with one padded everywhere (whose uniform softmax passes no
gradient back). Gates: float32 rtol = atol = 1e-5 (the forward's: two T <=
18 sums, and the dwords sum over the pixels, in another order); bfloat16
against the float32 gradient, no farther than JAX's bfloat16 gradient plus
the forward's bfloat16 gate, one bfloat16 step at the largest magnitude,
2^-7 max(1, |ref|max) (see that test). The CUDA backward kernel is held
against the same plain autograd on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py attention_bwd_phase).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgsr_tpu.ops.attention import word_pixel_attention as jax_wpa
from tgsr_tpu_torch.ops.attention import WordPixelAttention
from tgsr_tpu_torch.ops.fused_attention import word_pixel_attention
from tgsr_tpu_torch.ops.glu_requant import glu_requant, requant
from tgsr_tpu_torch.ops.int8_conv import int8_conv, pack_int8_weight
from tgsr_tpu_torch.ops.packed_tail import pack_up_head
from tgsr_tpu_torch.ops.up_head import prepare_up_head, up_head_site
from tgsr_tpu_torch.ops.up_head_packed import up_head_packed_site

torch.set_num_threads(1)


def _inputs(b, h, w, c, t, lens, seed):
    rng = np.random.default_rng(seed)
    px = rng.normal(size=(b, h, w, c)).astype(np.float32)
    wd = rng.normal(size=(b, t, c)).astype(np.float32)
    g = rng.normal(size=(b, h, w, c)).astype(np.float32)
    ga = rng.normal(size=(b, t, h, w)).astype(np.float32)
    mask = np.arange(t)[None, :] >= np.asarray(lens)[:, None]
    return px, wd, mask, g, ga


def _jax_grads(px, wd, mask, g, ga, dtype):
    def loss(p, w):
        ctx, attn = jax_wpa(p, w, jnp.asarray(mask))
        out = jnp.sum(ctx.astype(jnp.float32) * g)
        if ga is not None:
            out = out + jnp.sum(attn.astype(jnp.float32) * ga)
        return out

    return jax.grad(loss, argnums=(0, 1))(jnp.asarray(px, dtype), jnp.asarray(wd, dtype))


def _port_grads(px, wd, mask, g, ga, dtype):
    p = torch.from_numpy(px).to(dtype).requires_grad_()
    w = torch.from_numpy(wd).to(dtype).requires_grad_()
    ctx, attn = word_pixel_attention(p, w, torch.from_numpy(mask))
    out = (ctx.float() * torch.from_numpy(g)).sum()
    if ga is not None:
        out = out + (attn.float() * torch.from_numpy(ga)).sum()
    out.backward()
    return p.grad, w.grad


@pytest.mark.parametrize("with_attn", [False, True])
@pytest.mark.parametrize("shape,lens", [
    ((2, 8, 8, 8, 6), [6, 0]),           # one all-padded caption
    ((3, 16, 16, 32, 18), [18, 12, 0]),  # face S8 width, mixed lengths
])
def test_plain_grad_matches_jax_grad(shape, lens, with_attn):
    px, wd, mask, g, ga = _inputs(*shape, lens, seed=7)
    ga = ga if with_attn else None
    ref = _jax_grads(px, wd, mask, g, ga, jnp.float32)
    got = _port_grads(px, wd, mask, g, ga, torch.float32)
    for k, r in zip(got, ref):
        np.testing.assert_allclose(k.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
    # the all-padded caption: no gradient reaches its words through the softmax
    dwords = got[1][-1].numpy()
    assert np.isfinite(dwords).all()


@pytest.mark.parametrize("with_attn", [False, True])
def test_plain_grad_bf16_no_farther_than_jax_bf16(with_attn):
    """bfloat16 inputs and gradients: both frameworks round the logits, the
    softmax, dA and dS to bfloat16 at other places, and dS = a (dA - sum a
    dA) cancels, so the two bfloat16 gradients part by a few bfloat16 steps
    at the largest magnitude (0.35-0.5 of 20-27 here). Each is held against
    the float32 gradient on the same bfloat16-valued inputs: the port's max
    abs error at most JAX bfloat16's own plus one bfloat16 step at the
    largest magnitude, 2^-7 max(1, |ref|max) (the forward's gate)."""
    px, wd, mask, g, ga = _inputs(3, 16, 16, 32, 18, [18, 12, 0], seed=8)
    ga = ga if with_attn else None
    pxb = torch.from_numpy(px).bfloat16().float().numpy()
    wdb = torch.from_numpy(wd).bfloat16().float().numpy()
    ref = _jax_grads(pxb, wdb, mask, g, ga, jnp.float32)
    jax_bf16 = _jax_grads(pxb, wdb, mask, g, ga, jnp.bfloat16)
    got = _port_grads(pxb, wdb, mask, g, ga, torch.bfloat16)
    for k, j, r in zip(got, jax_bf16, ref):
        assert k.dtype == torch.bfloat16
        r = np.asarray(r)
        jax_err = np.abs(np.asarray(j, np.float32) - r).max()
        err = np.abs(k.float().numpy() - r).max()
        assert err <= jax_err + 2 ** -7 * max(1.0, np.abs(r).max()), (err, jax_err)


def test_padded_words_get_no_gradient_through_the_softmax():
    """A padded word's logit is replaced (the where-fill), so its gradient
    through the logits is 0; it still gets the ctx term a[p, t] g_p, with
    a[p, t] = 0 unless the whole caption is padded."""
    px, wd, mask, g, _ = _inputs(2, 8, 8, 8, 6, [3, 0], seed=9)
    got = _port_grads(px, wd, mask, g, None, torch.float32)
    np.testing.assert_array_equal(got[1][0, 3:].numpy(), 0.0)
    # an all-padded caption: uniform attention, dwords = sum_p g_p / T
    np.testing.assert_allclose(got[1][1].numpy(), np.broadcast_to(
        g[1].sum((0, 1)) / 6, (6, 8)), rtol=1e-5, atol=1e-5)


def test_module_grad_reaches_conv_context():
    """WordPixelAttention's projection weight gets its gradient through the
    attention (the fault the card path had: no grad_fn, no gradient)."""
    torch.manual_seed(0)
    att = WordPixelAttention(8, 12)
    px = torch.randn(2, 8, 4, 4, requires_grad=True)
    ctx, _ = att(px, torch.randn(2, 5, 12), torch.zeros(2, 5, dtype=torch.bool))
    ctx.square().sum().backward()
    assert att.conv_context.weight.grad is not None
    assert att.conv_context.weight.grad.abs().sum() > 0


def _up_head_weights(cin, c2, k):
    return [torch.randn(3, 3, cin, c2), torch.randn(c2), torch.randn(c2),
            torch.randn(k, k, c2 // 2, 3)]


@pytest.mark.parametrize("which", ["up_head_site", "up_head_packed_site", "int8_conv",
                                   "glu_requant", "requant"])
def test_serving_kernels_refuse_grad(which):
    """R2: the serving-only wrappers raise, naming the kernel, where grad
    mode is on and an input needs a gradient, on every device (their kernels
    write through raw pointers and would return a tensor without a grad_fn);
    under no_grad they run."""
    torch.manual_seed(1)
    x = torch.randn(1, 16, 4, 4, requires_grad=True)
    if which == "up_head_site":
        wts = prepare_up_head(*_up_head_weights(16, 32, 3))
        call = lambda: up_head_site(wts, x)
    elif which == "up_head_packed_site":
        wts = pack_up_head(*_up_head_weights(16, 32, 3))
        call = lambda: up_head_packed_site(wts, x)
    elif which == "int8_conv":
        q = torch.randint(-127, 128, (3, 3, 16, 8), dtype=torch.int8)
        xq = torch.randint(-127, 128, (1, 4, 4, 16), dtype=torch.int8)
        scale = torch.rand(8, requires_grad=True)
        call = lambda: int8_conv(xq, pack_int8_weight(q), scale, out_dtype=torch.float32)
    elif which == "glu_requant":
        h = torch.randn(2, 4, 64, requires_grad=True)
        call = lambda: glu_requant(h, 3.0)
    else:
        v = torch.randn(2, 4, 32, requires_grad=True)
        call = lambda: requant(v, 3.0)
    kernel = {"up_head_site": "up_head", "up_head_packed_site": "up_head_packed"}.get(which, which)
    with pytest.raises(RuntimeError, match=kernel):
        call()
    with torch.no_grad():
        assert call() is not None
