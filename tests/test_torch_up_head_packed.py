"""The parity-packed up-head of tgsr_tpu_torch against tgsr_tpu on the CPU.

The weight transforms (`fuse_upconv_kernel`, `pack_head_kernel`) are held
against the JAX numpy versions at rtol = atol = 1e-6 (the same sums of the
same float32 taps), the pixel shuffles exactly. The port's plain packed
chain and `fused_up_head_packed` on CPU tensors (which runs that chain) are
held against the JAX Pallas `fused_up_head_packed` in interpret mode and the
JAX `reference_up_head`, on the cases of tests/test_pallas_up_head.py:
float32 at rtol = atol = 1e-4 (float32 convolutions summed in another
order). In bfloat16 both sides take the same bfloat16 input, blend image and
blend weight and sum in float32; their weights differ by the rounding of the
fused up-conv taps (JAX rounds each tap to bfloat16 before it sums them,
the port rounds the float32 sums), and either may round a GLU value to the
neighbouring bfloat16. So both are bfloat16 computations of one float32
function with rounding errors of their own. Gates: the port's max error
against the float32 result (JAX on the same bfloat16-valued inputs) is at
most 1.25x JAX's own bfloat16 error (which element rounds worst differs),
and the RMS of port minus JAX bfloat16 is at most 1.5x the RMS of JAX's own
error (two independent errors of one size give sqrt(2)). The CUDA kernel is
held against the plain version on the card in
tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgsr_tpu.ops import blocks as jb
from tgsr_tpu.ops import fused_upsample as jfu
from tgsr_tpu.ops import packed_tail as jpt
from tgsr_tpu.ops import pallas_up_head as jup
from tgsr_tpu_torch.ops.blocks import depth_to_space, space_to_depth
from tgsr_tpu_torch.ops.fused_upsample import fuse_upconv_kernel
from tgsr_tpu_torch.ops.packed_tail import (pack_head_kernel, pack_up_head,
                                            packed_bn_glu, packed_head_conv,
                                            packed_up_head, upconv2x_packed)
from tgsr_tpu_torch.ops.up_head import fold_bn
from tgsr_tpu_torch.ops.up_head_packed import fused_up_head_packed, up_head_packed_site

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
W_TOL = dict(rtol=1e-6, atol=1e-6)


def _f(rng, *shape, sd=1.0):
    return (sd * rng.normal(size=shape)).astype(np.float32)


def _inputs(b, h, w, cin, c2, head_k, seed=0):
    rng = np.random.default_rng(seed)
    x = _f(rng, b, h, w, cin)
    w_up = _f(rng, 3, 3, cin, c2, sd=0.2)
    bn = (1 + _f(rng, c2, sd=0.1), _f(rng, c2, sd=0.1), _f(rng, c2, sd=0.1),
          np.abs(1 + _f(rng, c2, sd=0.2)))
    w_head = _f(rng, head_k, head_k, c2 // 2, 3, sd=0.2)
    srb = _f(rng, b, 2 * h, 2 * w, 3)
    return x, w_up, bn, w_head, srb


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _bf16(x):
    """float32 numpy -> the same values rounded to bfloat16 (torch tensor)."""
    return _t(x).bfloat16()


@pytest.mark.parametrize("cin,cout", [(4, 6), (16, 32)])
def test_fuse_upconv_kernel_matches_jax(cin, cout):
    w = _f(np.random.default_rng(cin), 3, 3, cin, cout)
    got = fuse_upconv_kernel(_t(w)).numpy()
    ref = jfu.fuse_upconv_kernel(w)
    assert got.shape == ref.shape == (2, 2, cin, 4 * cout)
    np.testing.assert_allclose(got, ref, **W_TOL)


@pytest.mark.parametrize("k", [3, 5])
def test_pack_head_kernel_matches_jax(k):
    wh = _f(np.random.default_rng(k), k, k, 8, 3)
    got = pack_head_kernel(_t(wh)).numpy()
    ref = jup.pack_head_kernel(wh)
    assert got.shape == ref.shape == (3, 3, 32, 12)
    np.testing.assert_allclose(got, ref, **W_TOL)


def test_pack_head_kernel_refuses_k7_as_jax():
    wh = np.zeros((7, 7, 4, 3), np.float32)
    with pytest.raises(ValueError, match="too large"):
        jup.pack_head_kernel(wh)
    with pytest.raises(ValueError, match="too large"):
        pack_head_kernel(_t(wh))


def test_depth_space_match_jax_exactly():
    x = np.arange(2 * 3 * 5 * 12, dtype=np.float32).reshape(2, 3, 5, 12)
    d2s = depth_to_space(_t(x), 2).numpy()
    np.testing.assert_array_equal(d2s, np.asarray(jb.depth_to_space(jnp.asarray(x), 2)))
    s2d = space_to_depth(_t(d2s), 2).numpy()
    np.testing.assert_array_equal(s2d, np.asarray(jb.space_to_depth(jnp.asarray(d2s), 2)))
    np.testing.assert_array_equal(s2d, x)


def test_packed_steps_match_jax():
    """upconv2x_packed, packed_bn_glu and packed_head_conv, one by one, on
    the shapes of tests/test_packed_tail.py (H != W)."""
    x, w_up, bn, w_head, _ = _inputs(2, 12, 20, 16, 32, 5, seed=4)
    mul, add = jup.fold_bn(*map(jnp.asarray, bn))
    wf = jfu.fuse_upconv_kernel(w_up)
    wh = jup.pack_head_kernel(w_head)
    y_ref = jpt.upconv2x_packed(jnp.asarray(x), jnp.asarray(wf))
    g_ref = jpt.packed_bn_glu(y_ref, mul, add)
    o_ref = jpt.packed_head_conv(g_ref, jnp.asarray(wh))
    y = upconv2x_packed(_t(x), _t(wf))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    g = packed_bn_glu(_t(np.asarray(y_ref)), _t(np.asarray(mul)), _t(np.asarray(add)))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), **TOL)
    o = packed_head_conv(_t(np.asarray(g_ref)), _t(wh))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), **TOL)


CASES = [
    # (h, w, cin, c2, head_k, tanh, blend, jax tile), as test_pallas_up_head
    (16, 16, 64, 64, 3, False, False, 8),
    (16, 16, 64, 64, 5, True, True, 8),
    (8, 8, 32, 64, 3, False, False, 16),
    (12, 12, 16, 32, 5, True, False, 4),  # non-pow2 H
]


def _jax_packed(x, w_up, mul, add, w_head, srb, a, cfg):
    _, _, _, _, head_k, use_tanh, blend, tile = cfg
    return np.asarray(jup.fused_up_head_packed(
        jnp.asarray(x), jnp.asarray(w_up), mul, add, jnp.asarray(w_head),
        jnp.asarray(srb), jnp.asarray(a), head_k=head_k, use_tanh=use_tanh,
        blend=blend, tile_rows=tile))


def _port_both(x, wts, srb, a, cfg):
    """(plain chain, wrapper on CPU tensors) of the port."""
    use_tanh, blend = cfg[5], cfg[6]
    return [fn(x, wts, srb, a, use_tanh=use_tanh, blend=blend).numpy()
            for fn in (packed_up_head, fused_up_head_packed)]


@pytest.mark.parametrize("cfg", CASES)
def test_port_matches_jax_f32(cfg):
    h, w, cin, c2, head_k, use_tanh, blend, _ = cfg
    x, w_up, bn, w_head, srb = _inputs(2, h, w, cin, c2, head_k, seed=1)
    mul, add = jup.fold_bn(*map(jnp.asarray, bn))
    ref_pallas = _jax_packed(x, w_up, mul, add, w_head, srb, 0.5, cfg)
    ref_xla = np.asarray(jup.reference_up_head(
        jnp.asarray(x), jnp.asarray(w_up), mul, add, jnp.asarray(w_head),
        jnp.asarray(srb), jnp.asarray(0.5), use_tanh=use_tanh, blend=blend))
    t_mul, t_add = fold_bn(*map(_t, bn))
    np.testing.assert_allclose(t_mul.numpy(), np.asarray(mul), **W_TOL)
    wts = pack_up_head(_t(w_up), t_mul, t_add, _t(w_head))
    for got in _port_both(_t(x), wts, _t(srb), torch.tensor(0.5), cfg):
        assert got.dtype == np.float32 and got.shape == (2, 2 * h, 2 * w, 3)
        np.testing.assert_allclose(got, ref_pallas, **TOL)
        np.testing.assert_allclose(got, ref_xla, **TOL)


@pytest.mark.parametrize("cfg", CASES)
def test_port_matches_jax_bf16(cfg):
    h, w, cin, c2, head_k, use_tanh, blend, _ = cfg
    x, w_up, bn, w_head, srb = _inputs(2, h, w, cin, c2, head_k, seed=2)
    mul, add = jup.fold_bn(*map(jnp.asarray, bn))
    xb, srbb = _bf16(x), _bf16(srb)
    ref_bf16 = _jax_packed(jnp.asarray(xb.float().numpy(), jnp.bfloat16), w_up, mul,
                           add, w_head, jnp.asarray(srbb.float().numpy(), jnp.bfloat16),
                           jnp.asarray(0.5, jnp.bfloat16), cfg)
    ref_f32 = _jax_packed(xb.float().numpy(), w_up, mul, add, w_head,
                          srbb.float().numpy(), 0.5, cfg)
    rms = lambda d: np.sqrt(np.mean(np.square(d)))  # noqa: E731
    t_mul, t_add = fold_bn(*map(_t, bn))
    wts = pack_up_head(_t(w_up), t_mul, t_add, _t(w_head), dtype=torch.bfloat16)
    assert wts.w_up.dtype == wts.w_head.dtype == torch.bfloat16
    assert wts.bn_mul.dtype == torch.float32
    for got in _port_both(xb, wts, srbb, torch.tensor(0.5, dtype=torch.bfloat16), cfg):
        assert got.dtype == np.float32
        assert np.abs(got - ref_f32).max() <= 1.25 * np.abs(ref_bf16 - ref_f32).max()
        assert rms(got - ref_bf16) <= 1.5 * rms(ref_bf16 - ref_f32)


def test_packed_head_padding_is_zero_glu():
    """The head conv pads the GLU output with zeros, not with GLU(bn_add):
    with a zero input and a zero up-conv the GLU is the constant
    GLU(bn_add) inside the image, so the interior is the head of that
    constant and an edge or corner pixel sees fewer taps."""
    x, _, bn, w_head, _ = _inputs(1, 4, 6, 8, 16, 5, seed=3)
    mul, add = fold_bn(*map(_t, bn))
    wts = pack_up_head(torch.zeros(3, 3, 8, 16), mul, add, _t(w_head))
    y = fused_up_head_packed(torch.zeros(1, 4, 6, 8), wts).numpy()
    g = (add[:8] * torch.sigmoid(add[8:])).numpy()  # the constant GLU value
    head = lambda wh: np.einsum("c,uvco->o", g, wh)  # noqa: E731
    np.testing.assert_allclose(y[0, 3, 5], head(w_head), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y[0, 0, 0], head(w_head[2:, 2:]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y[0, 7, 11], head(w_head[:3, :3]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y[0, 1, 5], head(w_head[1:]), rtol=1e-5, atol=1e-6)


def test_site_returns_working_dtype():
    """The generator site gives an NCHW image in x's dtype from the
    float32 output of the wrapper."""
    x, w_up, bn, w_head, srb = _inputs(2, 4, 4, 8, 16, 5, seed=5)
    mul, add = fold_bn(*map(_t, bn))
    wts = pack_up_head(_t(w_up), mul, add, _t(w_head), dtype=torch.bfloat16)
    xb = _bf16(x).permute(0, 3, 1, 2)
    srbb = _bf16(srb).permute(0, 3, 1, 2)
    a = torch.tensor(0.3, dtype=torch.bfloat16)
    y = up_head_packed_site(wts, xb, srb=srbb, a=a, use_tanh=True)
    assert y.dtype == torch.bfloat16 and y.shape == (2, 3, 8, 8)
    ref = fused_up_head_packed(_bf16(x), wts, _bf16(srb), a, use_tanh=True, blend=True)
    torch.testing.assert_close(y.permute(0, 2, 3, 1).float(),
                               ref.bfloat16().float(), rtol=0, atol=0)


def test_wrapper_refuses_other_devices_and_dtypes():
    """CPU tensors take the plain version; any device but CUDA raises, and
    any dtype but float32 and bfloat16 raises on every device."""
    wts = pack_up_head(torch.zeros(3, 3, 8, 16), torch.ones(16), torch.zeros(16),
                       torch.zeros(3, 3, 8, 3))
    with pytest.raises(ValueError, match="no kernel"):
        fused_up_head_packed(torch.empty(1, 4, 4, 8, device="meta"), wts)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            fused_up_head_packed(torch.zeros(1, 4, 4, 8, dtype=dtype), wts)
