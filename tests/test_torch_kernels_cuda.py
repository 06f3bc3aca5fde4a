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
elements (a gate or product on a bfloat16 rounding boundary); the int8
pipeline on the card against the same pipeline and scales on the CPU,
uint8 PSNR >= 40 dB.

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
from tgsr_tpu_torch.ops.attention import word_pixel_attention as plain_wpa
from tgsr_tpu_torch.ops.fused_attention import word_pixel_attention
from tgsr_tpu_torch.ops.glu_requant import INSTANCES, glu_requant, glu_requant_plain
from tgsr_tpu_torch.ops.int8_conv import int8_conv, int8_conv_plain, pack_int8_weight
from tgsr_tpu_torch.ops.packed_tail import pack_up_head, packed_up_head
from tgsr_tpu_torch.ops.up_head import fold_bn, fused_up_head, reference_up_head
from tgsr_tpu_torch.ops.up_head_packed import fused_up_head_packed

pytestmark = pytest.mark.cuda
ZERO = {name: 0 for name in _build.LAUNCH_NAMES}


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
])
def test_up_head_kernel_matches_plain(cuda_device, cfg):
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
    torch.cuda.synchronize()
    assert _build.LAUNCHES["up_head"] == before + 1
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


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
])
def test_int8_conv_matches_plain(cuda_device, cfg):
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


def test_pipeline_int8_card_matches_cpu(cuda_device):
    """The int8 pipeline (GF_DIM 32, so that the GLU widths are the kernel's
    64 and 32) on the card against the same pipeline and scales on the CPU:
    42 int8 convs, 6 + 10 GLU-requant passes and 3 attention launches per
    forward, no up-head."""
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
                                   glu_requant_one=6, glu_requant_pair=10)
    d = to_uint8(got["sr"].cpu()).double() - to_uint8(ref["sr"]).double()
    assert 10 * np.log10(255 ** 2 / max(d.square().mean().item(), 1e-12)) >= 40
