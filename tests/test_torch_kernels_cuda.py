"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here carries the `cuda` marker and skips without a card (the
`cuda_device` fixture decides, at run time). The file imports torch and
tgsr_tpu_torch only, so it runs where JAX is not installed:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_kernels_cuda.py

TF32 is off for every comparison (float32 convolutions would otherwise run
in TF32 through cuDNN). Gates: attention rtol = atol = 1e-5 (a T <= 18
softmax and two C = 32 sums in another order); up-head rtol = atol = 1e-4
(two float32 convolutions summed in another order, the gate of
tests/test_pallas_up_head.py); pipeline rtol = 1e-3, atol = 2e-4 on the
pyramid (tests/test_generator_parity.py).

int8: `int8_conv` against its plain version (a float64 convolution of the
int8 values, exact) bit for bit in the int32 sums and the float32 epilogue,
within one bfloat16 ulp in bfloat16; both `glu_requant` instances against
their plain version, int8 equal except one step in at most 0.1 % of the
elements (a gate or product on a bfloat16 rounding boundary), at main-path
widths and over every finite bfloat16 gate and value; `requant` against
`requant_plain` (`quantize_act`) bit for bit over every finite bfloat16; the
int8 pipeline on the card against the same pipeline and scales on the CPU,
uint8 PSNR >= 40 dB.

The conv probe's four tensor-core kernels (`tap9`, `im2col`, `pair5`,
`dotceil`) against their plain versions on the same bfloat16 inputs: within
one bfloat16 ulp elementwise (`conv_probe.max_ulps`: float32 sums in another
order, each output rounded once).

bfloat16: attention against the plain version in float32 on the same
bfloat16 inputs, rtol = 2^-8, atol = 1e-5 (the kernel computes in float32
and rounds each output once to bfloat16, half an ulp = 2^-9 relative); the
packed up-head against its plain version on the same bfloat16 inputs,
|err| <= 2e-2 * max(1, |ref|max) (float32 sums in another order can flip
the bfloat16 rounding of a GLU value, one ulp = 2^-8 relative, which the
head sums over 9 taps x C channels); the bfloat16 pipeline against the
float32 one on the CPU, PSNR >= 40 dB on [-1, 1] (the JAX package's own
bfloat16 reads 65 dB against its float32 on seeded weights).
"""

import numpy as np
import pytest
import torch

from tgsr_tpu_torch.checkpoints.from_jax import init_seeded
from tgsr_tpu_torch.config import Config, GanConfig, TextConfig, TreeConfig
from tgsr_tpu_torch.engine.inference import SRPipeline, to_uint8
from tgsr_tpu_torch.ops import _build
from tgsr_tpu_torch.ops import conv_probe
from tgsr_tpu_torch.ops.attention import word_pixel_attention as plain_wpa
from tgsr_tpu_torch.ops.fused_attention import word_pixel_attention
from tgsr_tpu_torch.ops.glu_requant import (INSTANCES, glu_requant, glu_requant_plain, requant,
                                            requant_plain)
from tgsr_tpu_torch.ops.int8_conv import int8_conv, int8_conv_plain, pack_int8_weight
from tgsr_tpu_torch.ops.packed_tail import pack_up_head, packed_up_head
from tgsr_tpu_torch.ops.up_head import (fold_bn, fused_up_head, prepare_up_head,
                                        reference_up_head, up_head_folded)
from tgsr_tpu_torch.ops.up_head_packed import fused_up_head_packed, prepare_up_head_packed

pytestmark = pytest.mark.cuda
ZERO = {name: 0 for name in _build.LAUNCH_NAMES}
# int8 steps: a power of two (exact ties), a calibrated-looking one, and one
# where a multiply by 1 / step without the kernel's guard misrounds
REQUANT_SCALES = [127.0 / 64, 3.0, 14.741072019324145]
CONV_NAMES = ["tap9", "im2col", "pair5", "dotceil"]  # the conv probe's formulations


def finite_bf16(device):
    """Every finite bfloat16 (65,280 bit patterns), ascending by bits."""
    bits = np.arange(1 << 16, dtype=np.uint32)
    bits = bits[((bits >> 7) & 0xFF) != 0xFF]
    return torch.from_numpy((bits << 16).view(np.float32)).bfloat16().to(device)


@pytest.fixture
def cuda_device():
    """The card, with TF32 off for float32 comparisons; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel against its plain version)")
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("hw", [32, 64, 128])
def test_attention_kernel_matches_plain(cuda_device, hw):
    """Main-path shapes (C 32, T 18), mixed lengths, one all-padded caption."""
    b, c, t = 4, 32, 18
    rng = np.random.default_rng(hw)
    px = torch.from_numpy(rng.normal(size=(b, hw, hw, c)).astype(np.float32))
    wd = torch.from_numpy(rng.normal(size=(b, t, c)).astype(np.float32))
    mask = torch.arange(t)[None, :] >= torch.tensor([18, 7, 0, 1])[:, None]
    args = [x.to(cuda_device) for x in (px, wd, mask)]
    ctx_p, attn_p = plain_wpa(*args)
    before = _build.LAUNCHES["word_pixel_attention"]
    ctx_k, attn_k = word_pixel_attention(*args)
    ctx_n, attn_n = word_pixel_attention(*args, return_attn=False)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["word_pixel_attention"] == before + 2
    assert attn_n is None
    torch.testing.assert_close(ctx_k, ctx_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(attn_k, attn_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ctx_n, ctx_k, rtol=0, atol=0)


@pytest.mark.parametrize("cfg", [
    # (b, h, w, cin, c2, k, tanh, blend)
    (2, 128, 128, 64, 64, 3, False, False),  # h_net3.upsample + img_net3
    (2, 128, 128, 32, 64, 5, True, True),    # upscale8x + conv_output + a*srb
    (2, 12, 12, 16, 32, 5, True, False),     # ragged tiles: 24 px output
    (1, 8, 8, 32, 64, 3, False, True),       # one tile
    (1, 13, 21, 32, 64, 5, True, True),      # B = 1, 26 x 42 output: ragged both ways
    (3, 9, 17, 8, 16, 3, False, True),       # C2 16 (the narrow test tree), ragged
])
def test_up_head_kernel_matches_plain(cuda_device, cfg):
    """The 3xTF32 kernel, given the combined weight made once and without it,
    against the plain float32 chain."""
    b, h, w, cin, c2, k, use_tanh, blend = cfg
    g = torch.Generator().manual_seed(h * cin + k)
    r = lambda *s, sd=1.0: (torch.randn(*s, generator=g) * sd).to(cuda_device)  # noqa: E731
    x, w_up, w_head = r(b, h, w, cin), r(3, 3, cin, c2, sd=0.2), r(k, k, c2 // 2, 3, sd=0.2)
    mul, add = fold_bn(1 + r(c2, sd=0.1), r(c2, sd=0.1), r(c2, sd=0.1),
                       (1 + r(c2, sd=0.2)).abs())
    srb, a = r(b, 2 * h, 2 * w, 3), torch.tensor(0.3, device=cuda_device)
    kw = dict(use_tanh=use_tanh, blend=blend)
    ref = reference_up_head(x, w_up, mul, add, w_head, srb, a, **kw)
    before = _build.LAUNCHES["up_head"]
    got = fused_up_head(x, w_up, mul, add, w_head, srb, a, **kw)
    got_f = up_head_folded(prepare_up_head(w_up, mul, add, w_head), x, srb, a, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["up_head"] == before + 2
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    assert torch.equal(got_f, got)


def test_pipeline_kernels_match_plain(cuda_device):
    """The card's pipeline against the same weights on the CPU, where every
    kernel site runs its plain version, at a narrow x8 tree: 3 attention and
    2 up-head launches per forward."""
    cfg = Config(TREE=TreeConfig(4, 8), GAN=GanConfig(8, 10, 2), TEXT=TextConfig(32, 6))
    sds = init_seeded(cfg, 41, torch.Generator().manual_seed(0))
    kern = SRPipeline(cfg, 41, *sds, device=cuda_device, return_attn=True)
    plain = SRPipeline(cfg, 41, *sds, device="cpu", return_attn=True)
    rng = np.random.default_rng(0)
    lr = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    cap = rng.integers(1, 41, (2, 6))
    cap[0, :] = 0
    cap[1, 4:] = 0
    lens = np.array([0, 4])
    ref = plain(lr, cap, lens)
    _build.reset_launches()
    got = kern(lr, cap, lens)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == dict(ZERO, word_pixel_attention=3, up_head=2)
    for p, pr in zip(got["pyramid"], ref["pyramid"]):
        torch.testing.assert_close(p.cpu(), pr, rtol=1e-3, atol=2e-4)
    for at, ar in zip(got["attn"], ref["attn"]):
        torch.testing.assert_close(at.cpu(), ar, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw", [32, 128])
def test_attention_kernel_bf16_matches_plain(cuda_device, hw):
    """bfloat16 in and out, main-path shapes, one all-padded caption."""
    b, c, t = 4, 32, 18
    rng = np.random.default_rng(hw + 1)
    px = torch.from_numpy(rng.normal(size=(b, hw, hw, c)).astype(np.float32))
    wd = torch.from_numpy(rng.normal(size=(b, t, c)).astype(np.float32))
    mask = torch.arange(t)[None, :] >= torch.tensor([18, 7, 0, 1])[:, None]
    px, wd, mask = (v.to(cuda_device) for v in (px.bfloat16(), wd.bfloat16(), mask))
    ctx_p, attn_p = plain_wpa(px.float(), wd.float(), mask)
    before = _build.LAUNCHES["word_pixel_attention"]
    ctx_k, attn_k = word_pixel_attention(px, wd, mask)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["word_pixel_attention"] == before + 1
    assert ctx_k.dtype == attn_k.dtype == torch.bfloat16
    torch.testing.assert_close(ctx_k.float(), ctx_p, rtol=2 ** -8, atol=1e-5)
    torch.testing.assert_close(attn_k.float(), attn_p, rtol=2 ** -8, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cfg", [
    # (b, h, w, cin, c2, k, tanh, blend)
    (2, 128, 128, 64, 64, 3, False, False),  # h_net3.upsample + img_net3
    (2, 128, 128, 32, 64, 5, True, True),    # upscale8x + conv_output + a*srb
    (2, 12, 20, 16, 32, 5, True, False),     # ragged tiles, H != W
    (1, 5, 7, 8, 16, 3, False, True),        # smaller than one tile
])
def test_up_head_packed_kernel_matches_plain(cuda_device, cfg, dtype):
    """The packed kernel against its plain version on the same inputs (in
    float32 also against row 2's plain version, the unpacked chain)."""
    b, h, w, cin, c2, k, use_tanh, blend = cfg
    g = torch.Generator().manual_seed(h * cin + k)
    r = lambda *s, sd=1.0: (torch.randn(*s, generator=g) * sd).to(cuda_device)  # noqa: E731
    x, w_up, w_head = r(b, h, w, cin), r(3, 3, cin, c2, sd=0.2), r(k, k, c2 // 2, 3, sd=0.2)
    mul, add = fold_bn(1 + r(c2, sd=0.1), r(c2, sd=0.1), r(c2, sd=0.1),
                       (1 + r(c2, sd=0.2)).abs())
    srb, a = r(b, 2 * h, 2 * w, 3), torch.tensor(0.3, device=cuda_device)
    kw = dict(use_tanh=use_tanh, blend=blend)
    wts = pack_up_head(w_up, mul, add, w_head, dtype=dtype)
    args = (x.to(dtype), wts, srb.to(dtype), a.to(dtype))
    ref = packed_up_head(*args, **kw)
    before = _build.LAUNCHES["up_head_packed"]
    got = fused_up_head_packed(*args, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["up_head_packed"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (b, 2 * h, 2 * w, 3)
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
        unpacked = reference_up_head(x, w_up, mul, add, w_head, srb, a, **kw)
        torch.testing.assert_close(got, unpacked, rtol=1e-4, atol=1e-4)
    else:
        err = (got - ref).abs().max().item()
        assert err <= 2e-2 * max(1.0, ref.abs().max().item()), err


@pytest.mark.parametrize("cfg", [
    # (h, w, cin, c2, k, tanh, blend): packed 24 x 40 leaves a partial column
    # of 8 x 16 tiles; 128 x 128 is the main path's
    (24, 40, 64, 64, 3, False, False),   # h_net3.upsample + img_net3
    (24, 40, 32, 64, 5, True, True),     # upscale8x + conv_output + a*srb
    (128, 128, 64, 64, 3, False, True),  # site A's convs, blend on
    (128, 128, 32, 64, 5, True, False),  # site B's convs, blend off
])
def test_up_head_packed_tensor_cores_bf16(cuda_device, cfg):
    """The bfloat16 tensor-core kernel at B = 3 against its plain version on
    the same inputs, with the fragment-ordered weights made once and per
    call (the same bits)."""
    h, w, cin, c2, k, use_tanh, blend = cfg
    b = 3
    g = torch.Generator().manual_seed(h * w + cin + k)
    r = lambda *s, sd=1.0: (torch.randn(*s, generator=g) * sd).to(cuda_device)  # noqa: E731
    x, w_up, w_head = r(b, h, w, cin), r(3, 3, cin, c2, sd=0.2), r(k, k, c2 // 2, 3, sd=0.2)
    mul, add = fold_bn(1 + r(c2, sd=0.1), r(c2, sd=0.1), r(c2, sd=0.1),
                       (1 + r(c2, sd=0.2)).abs())
    srb, a = r(b, 2 * h, 2 * w, 3).bfloat16(), torch.tensor(0.3, device=cuda_device).bfloat16()
    kw = dict(use_tanh=use_tanh, blend=blend)
    wts = prepare_up_head_packed(w_up, mul, add, w_head, dtype=torch.bfloat16)
    assert wts.w_up_frag is not None and wts.w_head_frag is not None
    xb = x.bfloat16()
    ref = packed_up_head(xb, wts, srb, a, **kw)
    before = _build.LAUNCHES["up_head_packed"]
    got = fused_up_head_packed(xb, wts, srb, a, **kw)
    per_call = fused_up_head_packed(xb, wts._replace(w_up_frag=None, w_head_frag=None), srb, a,
                                    **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["up_head_packed"] == before + 2
    assert got.dtype == torch.float32 and got.shape == (b, 2 * h, 2 * w, 3)
    assert torch.equal(per_call, got)
    err = (got - ref).abs().max().item()
    assert err <= 2e-2 * max(1.0, ref.abs().max().item()), err


def test_up_head_packed_bf16_refuses_what_it_cannot_load(cuda_device):
    """The tensor-core kernel copies 16 bytes at a time: Cin % 8 and a
    16-byte-aligned x, or the wrapper raises before any launch."""
    wts = prepare_up_head_packed(torch.randn(3, 3, 16, 32, device=cuda_device),
                                 torch.ones(32, device=cuda_device),
                                 torch.zeros(32, device=cuda_device),
                                 torch.randn(3, 3, 16, 3, device=cuda_device),
                                 dtype=torch.bfloat16)
    before = _build.LAUNCHES["up_head_packed"]
    flat = torch.zeros(2 * 4 * 4 * 16 + 1, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_up_head_packed(flat[1:].view(2, 4, 4, 16), wts)
    odd = prepare_up_head_packed(torch.randn(3, 3, 12, 32, device=cuda_device), wts.bn_mul,
                                 wts.bn_add, torch.randn(3, 3, 16, 3, device=cuda_device),
                                 dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="Cin % 8"):
        fused_up_head_packed(torch.zeros(2, 4, 4, 12, device=cuda_device, dtype=torch.bfloat16),
                             odd)
    assert _build.LAUNCHES["up_head_packed"] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 7, 18, 32])
def test_attention_kernel_ragged_tile_any_t(cuda_device, t, dtype):
    """20 x 20 pixels (not a multiple of the block's 128), T of every
    register bucket, mixed lengths with one all-padded caption (a uniform
    1 / T), attention map on and off; float32 against the plain version at
    1e-5, bfloat16 against the plain version in float32 on the same inputs
    (2^-8 relative + 1e-5)."""
    b, c = 3, 32
    rng = np.random.default_rng(t)
    px = torch.from_numpy(rng.normal(size=(b, 20, 20, c)).astype(np.float32))
    wd = torch.from_numpy(rng.normal(size=(b, t, c)).astype(np.float32))
    mask = torch.arange(t)[None, :] >= torch.tensor([t, 0, (t + 1) // 2])[:, None]
    px, wd, mask = (v.to(cuda_device) for v in (px.to(dtype), wd.to(dtype), mask))
    ctx_p, attn_p = plain_wpa(px.float(), wd.float(), mask)
    before = _build.LAUNCHES["word_pixel_attention"]
    ctx_k, attn_k = word_pixel_attention(px, wd, mask)
    ctx_n, attn_n = word_pixel_attention(px, wd, mask, return_attn=False)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["word_pixel_attention"] == before + 2
    assert attn_n is None and ctx_k.dtype == attn_k.dtype == dtype
    assert attn_k.shape == (b, t, 20, 20)
    assert torch.equal(ctx_n, ctx_k)
    torch.testing.assert_close(attn_k[1].float(), torch.full_like(attn_p[1], 1 / t),
                               rtol=2 ** -8, atol=0)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=2 ** -8, atol=1e-5)
    torch.testing.assert_close(ctx_k.float(), ctx_p, **tol)
    torch.testing.assert_close(attn_k.float(), attn_p, **tol)


def test_pipeline_bf16_card_matches_f32_cpu(cuda_device):
    """The bfloat16 pipeline on the card (3 attention and 2 packed up-head
    launches per forward, no row-2 launch) against the float32 pipeline on
    the CPU on the same weights; outputs come back float32."""
    cfg = Config(TREE=TreeConfig(4, 8), GAN=GanConfig(8, 10, 2), TEXT=TextConfig(32, 6))
    sds = init_seeded(cfg, 41, torch.Generator().manual_seed(0))
    kern = SRPipeline(cfg, 41, *sds, device=cuda_device, return_attn=True,
                      compute_dtype=torch.bfloat16)
    plain = SRPipeline(cfg, 41, *sds, device="cpu", return_attn=True)
    rng = np.random.default_rng(0)
    lr = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    cap = rng.integers(1, 41, (2, 6))
    cap[0, :] = 0
    cap[1, 4:] = 0
    lens = np.array([0, 4])
    ref = plain(lr, cap, lens)
    _build.reset_launches()
    got = kern(lr, cap, lens)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == dict(ZERO, word_pixel_attention=3, up_head_packed=2)
    assert all(p.dtype == torch.float32 for p in got["pyramid"] + got["attn"])
    mse = ((got["sr"].cpu().double() - ref["sr"].double()) ** 2).mean().item()
    assert 10 * np.log10(4 / mse) >= 40


@pytest.mark.parametrize("cfg", [
    # (b, h, w, cin, cout, k, up2, bn, residual)
    (2, 32, 32, 3, 64, 3, False, False, False),     # im2f_conv / convin (Cin padded to 4)
    (2, 32, 32, 64, 128, 3, False, True, False),    # GSRNetLow ResBlock conv1
    (2, 32, 32, 64, 64, 3, False, True, True),      # its conv2, + x
    (2, 17, 23, 32, 64, 3, True, True, False),      # an UpBlock, ragged tiles
    (2, 40, 40, 32, 3, 5, False, False, False),     # conv_output
    (1, 9, 7, 32, 3, 3, False, False, False),       # an image head, smaller than a tile
    (1, 13, 19, 64, 64, 3, True, True, True),       # up2 with BN and a residual, B = 1
    (2, 20, 36, 3, 64, 5, False, True, False),      # Cin 3 -> 4 folded, k 5 (K 100 -> 128)
    (2, 16, 40, 32, 32, 3, False, True, True),      # NetGHighWeight ResBlock conv2, + x
    (1, 11, 45, 32, 128, 5, False, False, True),    # Cout 128, k 5, + residual, ragged
])
def test_int8_conv_matches_plain(cuda_device, cfg):
    """The int8 tensor-core kernel: int32 sums and the float32 epilogue bit
    for bit, bfloat16 within one ulp (ragged tiles, folded 3-channel input,
    Cout 3 / 32 / 64 / 128, k 3 and 5, up2, BN, residual, B = 1)."""
    b, h, w, cin, cout, k, up2, bn, res = cfg
    g = torch.Generator(device=cuda_device).manual_seed(h * cin + k)
    x = torch.randint(-127, 128, (b, h, w, cin), generator=g, device=cuda_device,
                      dtype=torch.int8)
    wt = pack_int8_weight(torch.randint(-127, 128, (k, k, cin, cout), generator=g,
                                        device=cuda_device, dtype=torch.int8))
    scale = torch.rand(cout, generator=g, device=cuda_device) * 1e-5 + 1e-6
    affine = ((1 + 0.1 * torch.randn(cout, generator=g, device=cuda_device),
               0.1 * torch.randn(cout, generator=g, device=cuda_device)) if bn else None)
    ho, wo = (2 * h, 2 * w) if up2 else (h, w)
    resid = torch.randn(b, ho, wo, cout, generator=g, device=cuda_device).bfloat16() if res else None
    one = torch.ones(cout, device=cuda_device)
    before = _build.LAUNCHES["int8_conv"]
    acc = int8_conv(x, wt, one, out_dtype=torch.float32, up2=up2)
    f32 = int8_conv(x, wt, scale, bn=affine, out_dtype=torch.float32, up2=up2)
    bf = int8_conv(x, wt, scale, bn=affine, residual=resid, up2=up2)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["int8_conv"] == before + 3
    assert torch.equal(acc, int8_conv_plain(x, wt, one, out_dtype=torch.float32, up2=up2))
    assert torch.equal(f32, int8_conv_plain(x, wt, scale, bn=affine, out_dtype=torch.float32,
                                            up2=up2))
    ref = int8_conv_plain(x, wt, scale, bn=affine, residual=resid, up2=up2).float()
    ulp = 2.0 ** (torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
    assert ((bf.float() - ref).abs() <= ulp).all()


@pytest.mark.parametrize("c", sorted(INSTANCES))
@pytest.mark.parametrize("n", [2 * 64 * 64, 4097])
def test_glu_requant_matches_plain(cuda_device, c, n):
    """Both instances; n = 4097 leaves a ragged last row in the pair layout."""
    g = torch.Generator(device=cuda_device).manual_seed(c + n)
    h = (1.5 * torch.randn(n, 2 * c, generator=g, device=cuda_device)).bfloat16()
    name = INSTANCES[c]
    before = _build.LAUNCHES[name]
    got = glu_requant(h, 2.0)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    assert got.dtype == torch.int8 and got.shape == (n, c)
    d = (got.int() - glu_requant_plain(h, 2.0).int()).abs()
    assert d.max().item() <= 1 and (d > 0).double().mean().item() <= 1e-3


@pytest.mark.parametrize("c", sorted(INSTANCES))
@pytest.mark.parametrize("sweep", ["gate", "value"])
def test_glu_requant_every_bf16(cuda_device, c, sweep):
    """Every finite bfloat16 gate against four values, and every finite
    bfloat16 value against four gates: today's gate against the plain
    version (one step, at most 0.1 % of the elements)."""
    every = finite_bf16(cuda_device).reshape(-1, c)
    few = torch.tensor([1.0, -0.75, 0.3, 2.5] if sweep == "gate" else [0.0, 1.5, -2.0, 8.0],
                       device=cuda_device).bfloat16()
    rows = []
    for f in few:
        pair = (f.expand_as(every), every) if sweep == "gate" else (every, f.expand_as(every))
        rows.append(torch.cat(pair, dim=1))
    h = torch.cat(rows).contiguous()
    scale = 1.0 if sweep == "gate" else 3.0
    before = _build.LAUNCHES[INSTANCES[c]]
    got = glu_requant(h, scale)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[INSTANCES[c]] == before + 1
    d = (got.int() - glu_requant_plain(h, scale).int()).abs()
    print(f"glu_requant c {c}, every {sweep}: {int((d > 0).sum())} of {d.numel()} differ")
    assert d.max().item() <= 1 and (d > 0).double().mean().item() <= 1e-3


@pytest.mark.parametrize("scale", REQUANT_SCALES)
def test_requant_every_bf16(cuda_device, scale):
    """The kernel equals `quantize_act` bit for bit over every finite
    bfloat16, also on a ragged count (the tail done element by element) and
    on a view 16 bytes in; a view that breaks 16-byte alignment raises."""
    x = finite_bf16(cuda_device)
    before = _build.LAUNCHES["requant"]
    for v in (x, x[:-3], x[8:], x[8:-5].reshape(-1, 1)):
        got = requant(v, scale)
        assert got.dtype == torch.int8 and got.shape == v.shape
        assert torch.equal(got, requant_plain(v, scale))
    assert _build.LAUNCHES["requant"] == before + 4
    with pytest.raises(ValueError, match="16-byte aligned"):
        requant(x[1:], scale)
    with pytest.raises(ValueError, match="contiguous"):
        requant(x[:64].reshape(8, 8).t(), scale)
    with pytest.raises(TypeError, match="bfloat16"):
        requant(x.float(), scale)
    assert _build.LAUNCHES["requant"] == before + 4


def test_pipeline_int8_card_matches_cpu(cuda_device):
    """The int8 pipeline (GF_DIM 32, so that the GLU widths are the kernel's
    64 and 32) on the card against the same pipeline and scales on the CPU:
    42 int8 convs, 6 + 10 GLU-requant passes, 26 requantized conv inputs
    (every int8 conv but the 14 conv2 and 2 heads fed by a GLU-requant) and
    3 attention launches per forward, no up-head."""
    cfg = Config(TREE=TreeConfig(4, 8), GAN=GanConfig(32, 10, 2), TEXT=TextConfig(32, 6))
    sds = init_seeded(cfg, 41, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    lr = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    cap = rng.integers(1, 41, (2, 6))
    cap[0, :] = 0
    cap[1, 4:] = 0
    lens = np.array([0, 4])
    bf16 = SRPipeline(cfg, 41, *sds, device=cuda_device, compute_dtype=torch.bfloat16)
    scales = bf16.calibrate_quant(lr, cap, lens)
    kw = dict(compute_dtype=torch.bfloat16, quant_scales=scales)
    kern = SRPipeline(cfg, 41, *sds, device=cuda_device, **kw)
    plain = SRPipeline(cfg, 41, *sds, device="cpu", **kw)
    ref = plain(lr, cap, lens)
    _build.reset_launches()
    got = kern(lr, cap, lens)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == dict(ZERO, word_pixel_attention=3, int8_conv=42,
                                   glu_requant_one=6, glu_requant_pair=10, requant=26)
    d = to_uint8(got["sr"].cpu()).double() - to_uint8(ref["sr"]).double()
    assert 10 * np.log10(255 ** 2 / max(d.square().mean().item(), 1e-12)) >= 40


@pytest.mark.parametrize("shape", [(2, 32, 32), (3, 8, 96), (1, 4, 32), (5, 64, 96),
                                   (2, 4, 64)])
@pytest.mark.parametrize("name", CONV_NAMES)
def test_conv_probe_kernel_matches_plain(cuda_device, name, shape):
    """The conv kernels at B, H, W = shape (4 x 32 pixel tiles, the halo
    zero-padded at every image edge): one tile (1, 4, 32); 240 tiles, more
    than one wave of the persistent im2col and pair5 with a ragged last one
    (5, 64, 96); H = 4, the halo out of the image above and below (2, 4,
    64). dotceil on 2 * 512 and 3 * 100 rows (a ragged last block of 44
    rows) for the first two shapes, on B x H * W rows for the others."""
    b, h, w = shape
    g = torch.Generator().manual_seed(b * h * w)
    r = lambda *s, sd: (torch.randn(*s, generator=g) * sd).bfloat16().to(cuda_device)  # noqa: E731
    x, wt = r(b, h, w, 64, sd=0.1), r(3, 3, 64, 128, sd=0.05)
    wp = conv_probe.pack_w(wt)
    p = {(2, 32, 32): (2, 512), (3, 8, 96): (3, 100)}.get(shape, (b, h * w))
    p = r(*p, 640, sd=0.1)
    args = {"tap9": (x, wt), "im2col": (x, wp), "pair5": (x, wp), "dotceil": (p, wp)}[name]
    kernel, plain = getattr(conv_probe, name), getattr(conv_probe, f"{name}_plain")
    before = _build.LAUNCHES[f"conv_{name}"]
    got = kernel(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[f"conv_{name}"] == before + 1
    ref = plain(*args)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert conv_probe.max_ulps(got, ref) <= 1


def _probe_inputs(device, b=2, h=8, w=64, seed=5):
    """Each formulation's two inputs ({name: (a, w)}: x and the HWIO weight
    for tap9, x and wp = pack_w(it) for im2col and pair5, p [b * h * w, 640]
    and wp for dotceil) and the seeded draw r."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sd: (torch.randn(*s, generator=g) * sd).bfloat16().to(device)  # noqa: E731
    x, wt = r(b, h, w, 64, sd=0.1), r(3, 3, 64, 128, sd=0.05)
    wp = conv_probe.pack_w(wt)
    p = r(b * h * w, 640, sd=0.1)
    return {"tap9": (x, wt), "im2col": (x, wp), "pair5": (x, wp), "dotceil": (p, wp)}, r


@pytest.mark.parametrize("name", ["im2col", "pair5"])
def test_conv_probe_multiplies_the_tenth_half(cuda_device, name):
    """Rows 576-639 of wp (the duplicated tap 8, zero in `pack_w`) are not
    zero here: the kernels multiply them, as the TPU kernels do, and agree
    with the plain versions, which do too."""
    args, r = _probe_inputs(cuda_device)
    x, wp = args[name]
    wp[576:] = r(64, 128, sd=0.05)
    kernel, plain = getattr(conv_probe, name), getattr(conv_probe, f"{name}_plain")
    got = kernel(x, wp)
    torch.cuda.synchronize()
    ref = plain(x, wp)
    assert conv_probe.max_ulps(got, ref) <= 1
    wp0 = wp.clone()
    wp0[576:] = 0
    assert conv_probe.max_ulps(plain(x, wp0), ref) > 8  # the tenth half counts


def test_conv_probe_tap9_every_tap_counts(cuda_device):
    """tap9 with every tap's weight distinct and non-zero (tap j's values
    offset by 0.01 (j + 1)) against `tap9_plain`. Zeroing any one tap moves
    the plain result by more than 8 ulp, so a kernel that skipped a tap, or
    read one tap's weight or shift for another's, would fail."""
    args, r = _probe_inputs(cuda_device)
    x = args["tap9"][0]
    offset = 0.01 * torch.arange(1, 10, device=cuda_device).view(3, 3, 1, 1)
    wt = (r(3, 3, 64, 128, sd=0.05).float() + offset).bfloat16()
    got = conv_probe.tap9(x, wt)
    torch.cuda.synchronize()
    ref = conv_probe.tap9_plain(x, wt)
    assert conv_probe.max_ulps(got, ref) <= 1
    for j in range(9):
        w0 = wt.clone()
        w0[j // 3, j % 3] = 0
        assert conv_probe.max_ulps(conv_probe.tap9_plain(x, w0), ref) > 8


@pytest.mark.parametrize("m", [1, 44, 128, 200 * 128 + 77])
def test_conv_probe_dotceil_rows(cuda_device, m):
    """dotceil at M rows of p: one (the 128-row TMA box taller than the
    tensor), 44 (one ragged tile), 128 (one whole tile) and 25,677 (201
    tiles, more than one wave of 132 persistent blocks, a ragged last tile
    of 77 rows)."""
    g = torch.Generator().manual_seed(m)
    p = (torch.randn(m, 640, generator=g) * 0.1).bfloat16().to(cuda_device)
    wp = (torch.randn(640, 128, generator=g) * 0.05).bfloat16().to(cuda_device)
    got = conv_probe.dotceil(p, wp)
    torch.cuda.synchronize()
    ref = conv_probe.dotceil_plain(p, wp)
    assert got.shape == (m, 128)
    assert conv_probe.max_ulps(got, ref) <= 1


def _at_offset(t, offset):
    """A copy of t as a view `offset` elements into a larger zero tensor."""
    flat = torch.zeros(t.numel() + offset + 16, dtype=t.dtype, device=t.device)
    v = flat[offset:offset + t.numel()].view(t.shape)
    v.copy_(t)
    return v


@pytest.mark.parametrize("name", CONV_NAMES)
def test_conv_probe_offset_view(cuda_device, name):
    """Both inputs as 16-byte aligned views at an offset inside larger
    tensors: the tensor maps take their base addresses from the views."""
    args, _ = _probe_inputs(cuda_device)
    a0, w0 = args[name]
    a, w = _at_offset(a0, 8), _at_offset(w0, 24)
    assert a.data_ptr() % 16 == 0 and a.data_ptr() % 128 and w.data_ptr() % 128
    kernel, plain = getattr(conv_probe, name), getattr(conv_probe, f"{name}_plain")
    got = kernel(a, w)
    torch.cuda.synchronize()
    assert conv_probe.max_ulps(got, plain(a0, w0)) <= 1


@pytest.mark.parametrize("name", CONV_NAMES)
def test_conv_probe_refuses_what_it_cannot_load(cuda_device, name):
    """float32, a non-contiguous input and an input that is not 16-byte
    aligned raise before any launch (TMA takes 16-byte aligned, dense
    bfloat16)."""
    args, _ = _probe_inputs(cuda_device, h=32, w=32)
    a, w = args[name]
    kernel = getattr(conv_probe, name)
    before = dict(_build.LAUNCHES)
    with pytest.raises(TypeError):
        kernel(a.float(), w)
    with pytest.raises(ValueError):
        kernel(torch.cat([a, a], dim=-1)[..., :a.shape[-1]], w)  # rows twice as far apart
    with pytest.raises(ValueError):
        kernel(_at_offset(a, 1), w)
    with pytest.raises(ValueError):
        kernel(a, _at_offset(w, 1))
    assert _build.LAUNCHES == before
