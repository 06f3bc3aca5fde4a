"""The bf16 conv3x3 probe's four formulations (counterparts of the Pallas
kernels of examples/pallas_conv_probe.py: `tap9`, `im2col`, `pair5`,
`dotceil`).

The conv is h_net3's ResBlock conv1: x bf16 NHWC [B, H, W, 64] -> bf16
[B, H, W, 128], 3x3 SAME, float32 sums, rounded to bf16 once. Like the TPU
probe, the formulations fix Cin 64 and Cout 128 (the 128-lane pairing of
two 64-channel taps assumes them) and raise otherwise:

- `tap9(x, w)`: 9 shifted K = 64 products, w bf16 HWIO [3, 3, 64, 128];
- `im2col(x, wp)`: one [pixels, 640] patch matrix (taps paired into 5
  blocks of 128 channels, tap 8 duplicated into the 10th half), one
  product with the packed weight wp [640, 128] (`pack_w`, the dummy half
  zero);
- `pair5(x, wp)`: 5 paired K = 128 products, no patch matrix;
- `dotceil(p, wp)`: a plain [M, 640] @ [640, 128] product on a precomputed
  patch tensor p [..., 640].

Each plain version follows its own formulation in float32 from the bf16
operands and rounds to bf16 once. On a CPU tensor a wrapper runs its plain
version; on a CUDA tensor it launches its kernel in `csrc/conv_probe.cu`
or raises, also when the driver cannot encode a tensor map. All four
kernels run on the bf16 tensor cores through `wgmma`, their operands
brought in by TMA (tensor maps encoded at each call) in persistent blocks
with the weight resident: tap9 and pair5 share one body (the HWIO weight
seen as [576, 128] is `pack_w`'s first 576 rows), im2col builds its patch
matrix in shared memory, dotceil streams p through a ring of TMA stages.
Every CUDA input must be contiguous and 16-byte aligned (TMA's rule). The
conv kernels take H a multiple of 4 and W of 32; the wrappers ask the same
on either device. dotceil takes 1 <= M < 2^31 rows. `conv_library`
(cuDNN's bf16 conv) is the conv rows' yardstick, timed beside the kernels
and called by nothing else in the package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tgsr_tpu_torch.ops import _build

NAME = "conv_probe"
CIN, COUT, KP = 64, 128, 640
TILE_H, TILE_W = 4, 32  # a conv kernel block's output pixels


def pack_w(w: torch.Tensor) -> torch.Tensor:
    """HWIO [3, 3, 64, 128] -> bf16 [640, 128] in the paired-tap patch
    layout: rows 128p .. 128p + 63 tap 2p, the next 64 tap 2p + 1; the last
    64 rows (the duplicated tap 8) zero."""
    if tuple(w.shape) != (3, 3, CIN, COUT):
        raise ValueError(f"pack_w: w must be [3, 3, {CIN}, {COUT}], got {tuple(w.shape)}")
    wk = w.to(torch.bfloat16).reshape(9, CIN, COUT)
    out = torch.zeros(KP, COUT, dtype=torch.bfloat16, device=w.device)
    for p in range(5):
        out[p * 128:p * 128 + 64] = wk[2 * p]
        if 2 * p + 1 < 9:
            out[p * 128 + 64:(p + 1) * 128] = wk[2 * p + 1]
    return out


def _shifted(x: torch.Tensor, i: int) -> torch.Tensor:
    """Tap i of the SAME-padded float32 input as a [pixels, 64] matrix."""
    dy, dx = divmod(i, 3)
    b, h, w, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    return xp[:, dy:dy + h, dx:dx + w, :].reshape(b * h * w, CIN)


def tap9_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    b, h, wd, _ = x.shape
    wk = w.float().reshape(9, CIN, COUT)
    acc = torch.zeros(b * h * wd, COUT, dtype=torch.float32, device=x.device)
    for i in range(9):
        acc += _shifted(x, i) @ wk[i]
    return acc.reshape(b, h, wd, COUT).to(torch.bfloat16)


def _patches(x: torch.Tensor) -> torch.Tensor:
    """The [pixels, 640] float32 patch matrix: half j of a row is tap j, and
    the 10th half tap 8 again."""
    return torch.cat([_shifted(x, min(j, 8)) for j in range(10)], dim=1)


def im2col_plain(x: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    b, h, w, _ = x.shape
    return (_patches(x) @ wp.float()).reshape(b, h, w, COUT).to(torch.bfloat16)


def pair5_plain(x: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    b, h, w, _ = x.shape
    wf = wp.float()
    acc = torch.zeros(b * h * w, COUT, dtype=torch.float32, device=x.device)
    for p in range(5):
        pair = torch.cat([_shifted(x, 2 * p), _shifted(x, min(2 * p + 1, 8))], dim=1)
        acc += pair @ wf[p * 128:(p + 1) * 128]
    return acc.reshape(b, h, w, COUT).to(torch.bfloat16)


def dotceil_plain(p: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    return (p.float() @ wp.float()).to(torch.bfloat16)


def conv_library(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The probe's baseline (`xla_conv`): one `F.conv2d` in bf16 (cuDNN on the
    card, float32 sums), channels_last, x NHWC and w HWIO as the
    formulations take them."""
    wo = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    y = F.conv2d(x.permute(0, 3, 1, 2), wo, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def max_ulps(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest |got - ref| in bf16 ulps of ref, the ulp taken of
    max(|ref|, 2^-10 max|ref|). Two float32 sums of the same products in
    another order differ by about 1e-8 here, far below one bf16 ulp of any
    value above that floor; below it the ulp shrinks until the order alone
    could flip a rounding."""
    r = ref.float().abs()
    mag = torch.clamp(r, min=max(r.max().item() * 2.0 ** -10, 2.0 ** -126))
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((got.float() - ref.float()).abs() / ulp).max().item()


def _check(name: str, t: torch.Tensor, shape: tuple) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: needs bfloat16, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: a {tuple(t.shape)} input where the kernel takes {shape} "
                         f"(Cin {CIN}, Cout {COUT}, as the probe fixes them)")


def _check_conv(name: str, x: torch.Tensor, w: torch.Tensor, w_shape: tuple) -> None:
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be NHWC [B, H, W, {CIN}], got {tuple(x.shape)}")
    b, h, wd, _ = x.shape
    _check(name, x, (b, h, wd, CIN))
    _check(name, w, w_shape)
    if h % TILE_H or wd % TILE_W or h == 0 or wd == 0 or b == 0:
        raise ValueError(f"{name}: H {h} must be a multiple of {TILE_H} and W {wd} of "
                         f"{TILE_W} (the kernel's pixel tile)")


def _launch(name: str, fn: str, a: torch.Tensor, w: torch.Tensor, out: torch.Tensor,
            *dims: int) -> torch.Tensor:
    for t in (a, w):
        if t.device != out.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous, 16-byte aligned and on "
                             "one device")
    with torch.cuda.device(out.device):
        err = getattr(_build.library(NAME), fn)(
            a.data_ptr(), w.data_ptr(), out.data_ptr(), *dims,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out


def _conv(name: str, x: torch.Tensor, w: torch.Tensor, w_shape: tuple, plain) -> torch.Tensor:
    _check_conv(name, x, w, w_shape)
    if x.device.type == "cpu":
        return plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")
    b, h, wd, _ = x.shape
    out = torch.empty((b, h, wd, COUT), dtype=torch.bfloat16, device=x.device)
    return _launch(name, f"{name}_launch", x, w, out, b, h, wd)


def tap9(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x bf16 [B, H, W, 64], w bf16 HWIO [3, 3, 64, 128] -> bf16 [B, H, W, 128]."""
    return _conv("conv_tap9", x, w, (3, 3, CIN, COUT), tap9_plain)


def im2col(x: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """x bf16 [B, H, W, 64], wp bf16 [640, 128] -> bf16 [B, H, W, 128]."""
    return _conv("conv_im2col", x, wp, (KP, COUT), im2col_plain)


def pair5(x: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """x bf16 [B, H, W, 64], wp bf16 [640, 128] -> bf16 [B, H, W, 128]."""
    return _conv("conv_pair5", x, wp, (KP, COUT), pair5_plain)


def dotceil(p: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """p bf16 [..., 640] (any number of rows), wp bf16 [640, 128] -> bf16
    [..., 128]."""
    name = "conv_dotceil"
    if p.dim() < 1 or p.numel() == 0:
        raise ValueError(f"{name}: p must be a non-empty [..., {KP}], got {tuple(p.shape)}")
    _check(name, p, (*p.shape[:-1], KP))
    _check(name, wp, (KP, COUT))
    if p.device.type == "cpu":
        return dotceil_plain(p, wp)
    if p.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {p.device}")
    out = torch.empty((*p.shape[:-1], COUT), dtype=torch.bfloat16, device=p.device)
    return _launch(name, f"{name}_launch", p, wp, out, p.numel() // KP)
