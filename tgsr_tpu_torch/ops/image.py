"""Image processing and quality metrics on the device (counterpart of
tgsr_tpu/ops/image.py): normalization, the antialiased resize of
`jax.image.resize`, pyramids and the bicubic LR degrade, gaussian blur,
and the Y-channel PSNR / SSIM of the evaluation protocol.

Images are NHWC tensors, on whatever device they are given. The normalized
domain is [-1, 1]. Every function here is a plain tensor product, as its JAX
counterpart is (none reaches a Pallas kernel): the resize builds the
separable resampling matrices as `jax.image.resize` does and applies them
with `einsum`, and the blurs are depthwise `F.conv2d`.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F


# -- normalization (= transforms.ToTensor + Normalize((0.5,)*3, (0.5,)*3)) ----

def normalize_uint8(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [-1, 1]."""
    return x.float() / 127.5 - 1.0


def denormalize_to_uint8(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> uint8, round(clip((x + 1) * 127.5, 0, 255)) with
    round-half-to-even (the reference's save-time clip)."""
    return torch.round(torch.clamp((x + 1.0) * 127.5, 0.0, 255.0)).to(torch.uint8)


# -- resize: jax.image.resize's kernels and weights ---------------------------

def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1 - x.abs(), min=0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic with a = -0.5, for x >= 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


# the methods the package resizes with, under jax.image.resize's names
KERNELS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "linear": _triangle, "bilinear": _triangle, "cubic": _keys_cubic, "bicubic": _keys_cubic,
}


def resize_weights(in_size: int, out_size: int, method: str = "bilinear",
                   antialias: bool = True, device=None,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The [in, out] resampling matrix of `jax.image.resize`
    (jax/_src/image/scale.py `compute_weight_mat`, translation 0): sample
    positions (o + 0.5) / scale - 0.5, the kernel widened by 1 / scale when
    downsampling with antialias, weights normalised per output sample, and
    samples whose position lies outside the input zeroed. Computed in
    `dtype`: float32, or float64 as JAX computes it with x64 on."""
    kernel = KERNELS[method]
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    f = dict(dtype=dtype, device=device)
    sample = (torch.arange(out_size, **f) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, **f)[:, None]).abs() / kernel_scale
    w = kernel(x)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize(x: torch.Tensor, size: Tuple[int, int], method: str = "bilinear",
           antialias: bool = True) -> torch.Tensor:
    """NHWC float resize, `jax.image.resize(x, (b, h, w, c), method,
    antialias)`: "linear" is a triangle kernel and "cubic" Keys' cubic with
    a = -0.5 (F.interpolate's bicubic is a = -0.75, with another
    antialias); a dimension whose size does not change is left as it is.
    The matrices are float32, float64 for a float64 x (a float64 step is
    then float64 throughout, as JAX's with x64), in x's type when applied."""
    if method not in KERNELS:
        raise ValueError(f"resize method {method!r}: the port resizes with {sorted(KERNELS)}")
    h, w = x.shape[1:3]
    wdt = torch.float64 if x.dtype == torch.float64 else torch.float32
    if h != size[0]:
        wr = resize_weights(h, size[0], method, antialias, x.device, wdt).to(x.dtype)
        x = torch.einsum("bhwc,ho->bowc", x, wr)
    if w != size[1]:
        wc = resize_weights(w, size[1], method, antialias, x.device, wdt).to(x.dtype)
        x = torch.einsum("bhwc,wp->bhpc", x, wc)
    return x


def build_pyramid(hr: torch.Tensor, n_branches: int, base_size: int,
                  method: str = "bilinear") -> List[torch.Tensor]:
    """Per-branch target pyramid: ret[i] = resize(img, base * 2^i), the
    full-resolution image itself at its own size."""
    out = []
    for i in range(n_branches):
        s = base_size * 2 ** i
        out.append(hr if hr.shape[1] == s else resize(hr, (s, s), method))
    return out


def degrade_and_bicubic(hr: torch.Tensor, scale: int, method: str = "bilinear"
                        ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """LR = resize(HR, 1 / scale); bic[i] = cubic resize of LR to each
    pyramid size, the full resolution last. Returns (lr, bic)."""
    h, w = hr.shape[1:3]
    lr = resize(hr, (h // scale, w // scale), method)
    bic = []
    s = h // scale
    while True:
        s *= 2
        if s >= h:
            break
        bic.append(resize(lr, (s, s), "cubic"))
    bic.append(resize(lr, (h, w), "cubic"))
    return lr, bic


def resize_bicubic_torch(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NHWC resize by F.interpolate(mode='bicubic', align_corners=False),
    where the reference's losses depend on torch's kernel (Keys with
    a = -0.75, no antialias; the JAX package rebuilds its matrices)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bicubic",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


# -- geometry ------------------------------------------------------------------

def crop_to_scale_multiple(img: torch.Tensor, scale: int) -> torch.Tensor:
    """H, W cropped down to multiples of `scale` (arbitrary-size eval
    images, so that the LR degrade divides exactly)."""
    h, w = img.shape[1:3]
    return img[:, :(h // scale) * scale, :(w // scale) * scale]


def bucket_shape(h: int, w: int, scale: int, bucket: int = 64) -> Tuple[int, int]:
    """(h, w) rounded up to multiples of `bucket` (at least `scale`), so
    that arbitrary-size inputs come in a bounded set of shapes."""
    bucket = max(bucket, scale)
    return -(-h // bucket) * bucket, -(-w // bucket) * bucket


def pad_to(img: torch.Tensor, h: int, w: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """NHWC image edge-padded up to (h, w); returns (padded, original
    (h, w))."""
    oh, ow = img.shape[1:3]
    rows = torch.arange(h, device=img.device).clamp(max=oh - 1)
    cols = torch.arange(w, device=img.device).clamp(max=ow - 1)
    return img[:, rows][:, :, cols], (oh, ow)


# -- gaussian blur (= PIL ImageFilter.GaussianBlur(radius=2)) ------------------

def _gauss(half: int, sigma: float, device) -> torch.Tensor:
    xs = torch.arange(-half, half + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (xs / sigma) ** 2)
    return k / k.sum()


def _depthwise(z: torch.Tensor, k: torch.Tensor, dim: int) -> torch.Tensor:
    """NCHW z, valid depthwise correlation with the 1-D kernel k along H
    (dim 2) or W (dim 3)."""
    c = z.shape[1]
    shape = (c, 1, k.numel(), 1) if dim == 2 else (c, 1, 1, k.numel())
    return F.conv2d(z, k.reshape(shape[1:]).expand(shape), groups=c)


def gaussian_blur(x: torch.Tensor, radius: float = 2.0) -> torch.Tensor:
    """Separable depthwise gaussian blur, sigma = radius, support
    2 * ceil(2 * sigma) + 1, edge-replicated borders, NHWC float:
    horizontal, then vertical."""
    sigma = float(radius)
    half = int(math.ceil(sigma * 2.0))
    k = _gauss(half, sigma, x.device).to(x.dtype)
    z = x.permute(0, 3, 1, 2)
    z = _depthwise(F.pad(z, (half, half, 0, 0), mode="replicate"), k, 3)
    z = _depthwise(F.pad(z, (0, 0, half, half), mode="replicate"), k, 2)
    return z.permute(0, 2, 3, 1)


# -- metrics --------------------------------------------------------------------

def rgb2y(rgb_uint8: torch.Tensor) -> torch.Tensor:
    """BT.601 luma, uint8 -> uint8 (truncated, as the reference)."""
    rgb = rgb_uint8.float() / 255.0
    coef = torch.tensor([65.481, 128.553, 24.966], dtype=torch.float32,
                        device=rgb.device) / 255.0
    y = (rgb * coef).sum(-1) + 16.0 / 255.0
    return (y * 255.0 + 0.5).to(torch.uint8)


def psnr(im1: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
    """20 log10(255 / RMSE) over all of both arrays, in float32."""
    diff = im1.float() - im2.float()
    return 20.0 * torch.log10(255.0 / torch.sqrt(torch.mean(diff ** 2)))


def psnr_batch(im1: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
    """Per-image PSNR over a batch (any float or uint8 dtype in [0, 255])."""
    diff = im1.float() - im2.float()
    mse = torch.mean(diff ** 2, dim=tuple(range(1, diff.ndim)))
    return 20.0 * torch.log10(255.0 / torch.sqrt(mse))


def ssim(im1: torch.Tensor, im2: torch.Tensor, data_range: float = 255.0,
         filter_size: int = 11, filter_sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Per-image mean SSIM over a batch, NHWC, gaussian-windowed (Wang et
    al.; skimage's structural_similarity with gaussian_weights=True,
    use_sample_covariance=False), valid windows only."""
    x, y = im1.float().permute(0, 3, 1, 2), im2.float().permute(0, 3, 1, 2)
    k = _gauss(filter_size // 2, filter_sigma, x.device)
    blur = lambda z: _depthwise(_depthwise(z, k, 3), k, 2)
    mu_x, mu_y = blur(x), blur(y)
    mu_x2, mu_y2, mu_xy = mu_x ** 2, mu_y ** 2, mu_x * mu_y
    sigma_x2 = blur(x * x) - mu_x2
    sigma_y2 = blur(y * y) - mu_y2
    sigma_xy = blur(x * y) - mu_xy
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = ((2 * mu_xy + c1) * (2 * sigma_xy + c2)) / (
        (mu_x2 + mu_y2 + c1) * (sigma_x2 + sigma_y2 + c2))
    return s.mean(dim=(1, 2, 3))
