"""tgsr_tpu_torch/ops/image.py against tgsr_tpu/ops/image.py on the same
numpy-seeded inputs, on the CPU.

Tolerances: the resizes (jax.image.resize's linear and cubic, antialiased,
up and down, square and not; torch's bicubic weights), the gaussian blur
and SSIM within 1e-5 absolute (float32 sums of the same products in
another order), in float64 within 1e-12 of JAX's with x64 on; rgb2y,
normalize and denormalize equal; PSNR within 1e-4 dB.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgsr_tpu.ops import image as jimage
from tgsr_tpu_torch.ops import image as timage

torch.set_num_threads(1)


def _pair(x):
    return jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("method", ["linear", "bilinear", "cubic"])
@pytest.mark.parametrize("src, dst", [
    ((16, 16), (8, 8)), ((16, 16), (40, 40)), ((12, 20), (5, 7)), ((9, 6), (27, 13)),
    ((64, 64), (8, 8)), ((10, 10), (10, 3)),
])
def test_resize_matches_jax(method, src, dst):
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, *src, 3)).astype(np.float32)
    j, t = _pair(x)
    _close(timage.resize(t, dst, method), jimage.resize(j, dst, method), 1e-5)


@pytest.mark.parametrize("method", ["bilinear", "cubic"])
@pytest.mark.parametrize("src, dst", [((32, 32), (137, 137)), ((256, 256), (137, 137)),
                                      ((12, 20), (5, 7))])
def test_resize_float64_matches_jax_x64(method, src, dst):
    """A float64 resize is float64 throughout, its matrices too, as JAX's
    with x64 on: within 1e-12 (float32 matrices would part by 1e-7)."""
    import jax

    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (2, *src, 3))
    with jax.enable_x64(True):
        want = jimage.resize(jnp.asarray(x), dst, method)
        assert want.dtype == jnp.float64
    got = timage.resize(torch.from_numpy(x), dst, method)
    assert got.dtype == torch.float64
    _close(got, want, 1e-12)


@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_resize_without_antialias(method):
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (1, 17, 11, 2)).astype(np.float32)
    j, t = _pair(x)
    for dst in ((6, 5), (30, 23)):
        _close(timage.resize(t, dst, method, antialias=False),
               jimage.resize(j, dst, method, antialias=False), 1e-5)
    with pytest.raises(ValueError, match="resize method"):
        timage.resize(t, (6, 5), "lanczos3")


def test_pyramid_and_degrade_match_jax():
    rng = np.random.default_rng(2)
    hr = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    j, t = _pair(hr)
    for got, want in zip(timage.build_pyramid(t, 4, 8), jimage.build_pyramid(j, 4, 8)):
        _close(got, want, 1e-5)
    lr_t, bic_t = timage.degrade_and_bicubic(t, 8)
    lr_j, bic_j = jimage.degrade_and_bicubic(j, 8)
    _close(lr_t, lr_j, 1e-5)
    assert len(bic_t) == len(bic_j) == 3
    for got, want in zip(bic_t, bic_j):
        _close(got, want, 1e-5)


@pytest.mark.parametrize("src, dst", [((8, 8), (16, 16)), ((12, 9), (7, 20))])
def test_resize_bicubic_torch_matches_jax_and_interpolate(src, dst):
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (2, *src, 3)).astype(np.float32)
    j, t = _pair(x)
    got = timage.resize_bicubic_torch(t, dst)
    _close(got, jimage.resize_bicubic_torch(j, dst), 1e-5)
    ref = torch.nn.functional.interpolate(t.permute(0, 3, 1, 2), size=dst, mode="bicubic",
                                          align_corners=False).permute(0, 2, 3, 1)
    _close(got, ref.numpy(), 1e-5)


def test_normalize_rgb2y_and_geometry_equal_jax():
    rng = np.random.default_rng(4)
    u8 = rng.integers(0, 256, (3, 13, 21, 3)).astype(np.uint8)
    j, t = _pair(u8)
    np.testing.assert_array_equal(timage.normalize_uint8(t).numpy(),
                                  np.asarray(jimage.normalize_uint8(j)))
    np.testing.assert_array_equal(timage.rgb2y(t).numpy(), np.asarray(jimage.rgb2y(j)))
    f = np.concatenate([rng.uniform(-1.2, 1.2, 4000), (np.arange(256) + 0.5) / 127.5 - 1.0]
                       ).astype(np.float32).reshape(1, 1, -1, 1)
    jf, tf = _pair(f)
    np.testing.assert_array_equal(timage.denormalize_to_uint8(tf).numpy(),
                                  np.asarray(jimage.denormalize_to_uint8(jf)))
    np.testing.assert_array_equal(timage.crop_to_scale_multiple(t, 4).numpy(),
                                  np.asarray(jimage.crop_to_scale_multiple(j, 4)))
    got, size = timage.pad_to(t, 16, 24)
    want, wsize = jimage.pad_to(j, 16, 24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert size == wsize == (13, 21)
    assert timage.bucket_shape(40, 57, 8) == jimage.bucket_shape(40, 57, 8) == (64, 64)


@pytest.mark.parametrize("radius", [2.0, 1.0, 0.7])
def test_gaussian_blur_matches_jax(radius):
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (2, 19, 14, 3)).astype(np.float32)
    j, t = _pair(x)
    _close(timage.gaussian_blur(t, radius), jimage.gaussian_blur(j, radius), 1e-5)


def test_psnr_and_ssim_match_jax():
    rng = np.random.default_rng(6)
    a = rng.integers(0, 256, (4, 32, 40, 1)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 12, a.shape), 0, 255).astype(np.float32)
    (ja, ta), (jb, tb) = _pair(a), _pair(b)
    _close(timage.psnr_batch(ta, tb), jimage.psnr_batch(ja, jb), 1e-4)
    _close(timage.psnr(ta, tb), jimage.psnr(ja, jb), 1e-4)
    _close(timage.ssim(ta, tb), jimage.ssim(ja, jb), 1e-5)
    rgb = rng.integers(0, 256, (2, 24, 24, 3)).astype(np.float32)
    (jr, tr), (jn, tn) = _pair(rgb), _pair(np.clip(rgb + 9, 0, 255).astype(np.float32))
    _close(timage.ssim(tr, tn), jimage.ssim(jr, jn), 1e-5)
