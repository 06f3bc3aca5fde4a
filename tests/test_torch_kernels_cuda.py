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
uint8 PSNR >= 40 dB. X3, `int8_upconv_phases` (the UpBlock as four int8
phase convs, csrc/int8_upconv.cu), against its plain version: float32
within 4 ulps, bfloat16 within one ulp, one quant step where the value sits
within 2^-20 of a half-step; the int8 forward with every UpBlock by phases
on the card >= 40 dB against the CPU's.

The conv probe's four tensor-core kernels (`tap9`, `im2col`, `pair5`,
`dotceil`) against their plain versions on the same bfloat16 inputs: within
one bfloat16 ulp elementwise (`conv_probe.max_ulps`: float32 sums in another
order, each output rounded once).

The attention forward and backward at the x16 family's 256 px training
site (B = 16, ragged and edge masks), and C 5: a float32 pipeline built on
the card runs with TF32 off whatever the process had set.

DAMSM (no kernel of its own): a DAMSMTrainer step (SimpleCNN and
Inception) and a GAN step with the DAMSM terms on the card against the
same steps on the CPU (metrics rtol 1e-4; gradients relative L2 1e-3 per
tensor), and the attention's backward kernel reached by the DAMSM terms'
gradient alone.

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
from tgsr_tpu_torch.config import Config, EvalConfig, GanConfig, TextConfig, TreeConfig
from tgsr_tpu_torch.engine import inference
from tgsr_tpu_torch.engine.quant import act_step
from tgsr_tpu_torch.engine.inference import SRPipeline, to_uint8
from tgsr_tpu_torch.ops import _build
from tgsr_tpu_torch.ops import conv_probe
from tgsr_tpu_torch.ops.attention import word_pixel_attention as plain_wpa
from tgsr_tpu_torch.ops.fused_attention import word_pixel_attention
from tgsr_tpu_torch.ops.glu_requant import (INSTANCES, glu_requant, glu_requant_plain, requant,
                                            requant_plain)
from tgsr_tpu_torch.ops.int8_conv import int8_conv, int8_conv_plain, pack_int8_weight
from tgsr_tpu_torch.ops.int8_upconv import (int8_upconv_phases, int8_upconv_plain,
                                            matches_plain, pack_phase_weight)
from tgsr_tpu_torch.ops.packed_tail import pack_up_head, packed_up_head
from tgsr_tpu_torch.ops.up_head import (fold_bn, fused_up_head, prepare_up_head,
                                        reference_up_head, up_head_folded)
from tgsr_tpu_torch.ops.up_head_packed import fused_up_head_packed, prepare_up_head_packed
from tgsr_tpu_torch.utils import memory

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


@pytest.mark.parametrize("hw", [32, 64, 128, 256])
def test_attention_kernel_matches_plain(cuda_device, hw):
    """Main-path shapes (C 32, T 18; 256 px the x16 family's last site),
    mixed lengths, one all-padded caption."""
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


def _attention_grads(px, wd, mask, g, ga, fn):
    """(dpixels, dwords) of sum(ctx * g) + sum(attn * ga) through `fn`."""
    px = px.detach().requires_grad_()
    wd = wd.detach().requires_grad_()
    ctx, attn = fn(px, wd, mask, return_attn=ga is not None)
    loss = (ctx * g).sum() + ((attn * ga).sum() if ga is not None else 0)
    return torch.autograd.grad(loss, (px, wd))


def _check_backward(b, hw, t, lens, dtype, with_attn_grad, seed, device, mask=None):
    """The backward kernel (through autograd) against autograd of the plain
    version in float32 on the same inputs. float32: max abs error <= 1e-5
    max(1, |ref|max) (T-term softmax sums and a dwords sum over up to 256^2
    pixels in another order); bfloat16: |err| <= 2^-8 |ref| + 1e-5 max(1,
    |ref|max) (float32 inside, each output rounded once). Two runs equal bit
    for bit. `mask` ([b, t], True = padded) in place of the one `lens`
    makes. Returns the kernel's grads."""
    c = 32
    rng = np.random.default_rng(seed)
    px, wd, g = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device).to(dtype)
                 for shape in ((b, hw, hw, c), (b, t, c), (b, hw, hw, c)))
    ga = (torch.from_numpy(rng.normal(size=(b, t, hw, hw)).astype(np.float32)).to(device)
          .to(dtype) if with_attn_grad else None)
    if mask is None:
        mask = torch.arange(t)[None, :] >= torch.tensor(lens)[:, None]
    mask = mask.to(device)
    ref = _attention_grads(px.float(), wd.float(), mask, g.float(),
                           ga.float() if ga is not None else None, plain_wpa)
    before = dict(_build.LAUNCHES)
    got = _attention_grads(px, wd, mask, g, ga, word_pixel_attention)
    again = _attention_grads(px, wd, mask, g, ga, word_pixel_attention)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["word_pixel_attention"] == before["word_pixel_attention"] + 2
    assert _build.LAUNCHES["word_pixel_attention_bwd"] == before["word_pixel_attention_bwd"] + 2
    for k, r, a in zip(got, ref, again):
        assert k.dtype == dtype and torch.equal(k, a)
        scale = 1e-5 * max(1.0, r.abs().max().item())
        err = (k.float() - r).abs()
        if dtype == torch.float32:
            assert err.max().item() <= scale, (err.max().item(), scale)
        else:
            assert (err - 2 ** -8 * r.abs()).max().item() <= scale
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [32, 64, 128])
def test_attention_backward_matches_plain_autograd(cuda_device, hw, dtype):
    """The training sites (C 32, T 18), ragged captions with one padded
    everywhere, a gradient on the attention map at 64 px."""
    _check_backward(4, hw, 18, [18, 7, 0, 1], dtype, hw == 64, hw, cuda_device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 7, 18, 32])
def test_attention_backward_ragged_tile_any_t(cuda_device, t, dtype):
    """20 x 20 pixels (a ragged last tile), T of every register bucket, the
    attention map's gradient on."""
    _check_backward(3, 20, t, [t, 0, (t + 1) // 2], dtype, True, t, cuda_device)


def x16_train_mask(kind, b=16, t=18):
    """The masks of the x16 train-site test, True = padded: ragged lengths
    (one caption padded everywhere), every token padded, or no padding but
    one token."""
    if kind == "ragged":
        lens = torch.from_numpy(np.random.default_rng(16).integers(1, t + 1, b))
        lens[1] = 0
        return torch.arange(t)[None, :] >= lens[:, None]
    if kind == "all padded":
        return torch.ones(b, t, dtype=torch.bool)
    mask = torch.zeros(b, t, dtype=torch.bool)
    mask[:, 5] = True
    return mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["ragged", "all padded", "one token padded"])
def test_attention_x16_train_site_256px(cuda_device, kind, dtype):
    """The x16 family's largest training site: 256 px at B = 16 (1,048,576
    pixel rows a call; the backward's tiles, its partial-dW buffer and the
    second launch that sums it at that size), C 32, T 18, no attention-map
    gradient (as the step runs it), forward and backward against the plain
    version at the gates above."""
    b, hw, t, c = 16, 256, 18, 32
    mask = x16_train_mask(kind, b, t).to(cuda_device)
    rng = np.random.default_rng(256)
    px, wd = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda_device)
              .to(dtype) for shape in ((b, hw, hw, c), (b, t, c)))
    # the plain version in float32 on the same (bfloat16-rounded) inputs
    ctx_p, _ = plain_wpa(px.float(), wd.float(), mask, return_attn=False)
    ctx_k, _ = word_pixel_attention(px, wd, mask, return_attn=False)
    err = (ctx_k.float() - ctx_p).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-5 * max(1.0, ctx_p.abs().max().item())
    else:
        assert (err - 2 ** -8 * ctx_p.abs()).max().item() <= 1e-5 * max(1.0, ctx_p.abs().max().item())
    _check_backward(b, hw, t, None, dtype, False, 16, cuda_device, mask=mask)


def test_float32_pipeline_turns_tf32_off(cuda_device, capsys):
    """C 5: a float32 SRPipeline built on the card turns cuDNN's and cuBLAS's
    TF32 off for the process, whatever the caller had set, so its B = 4
    output equals, bit for bit, that of a pipeline built with TF32 off (the
    face S8 geometry at full width, seeded weights), and logs it in one line
    where it turned a switch off. The control: TF32 on again after the
    build changes that output. bfloat16 and int8 pipelines leave the
    switches as they are."""
    from tgsr_tpu_torch.config import face_s8_config
    from tgsr_tpu_torch.engine.precision import FLOAT32_MATH_NOTE

    cfg = face_s8_config()
    sds = init_seeded(cfg, 41, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    lr = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    cap = rng.integers(1, 41, (4, 18))
    lens = np.array([18, 7, 0, 12])
    cap[np.arange(18)[None, :] >= lens[:, None]] = 0
    out = {}
    for on in (True, False):
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
        pipe = SRPipeline(cfg, 41, *sds, device=cuda_device)
        assert pipe.pins_float32_math
        assert capsys.readouterr().out.count(FLOAT32_MATH_NOTE) == (1 if on else 0)
        assert not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32)
        out[on] = pipe(lr, cap, lens)["sr"]
    assert torch.equal(out[True], out[False])
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    assert not torch.equal(pipe(lr, cap, lens)["sr"], out[False])
    bf16 = SRPipeline(cfg, 41, *sds, device=cuda_device, compute_dtype=torch.bfloat16)
    scales = bf16.calibrate_quant(lr, cap, lens)
    int8 = SRPipeline(cfg, 41, *sds, device=cuda_device, compute_dtype=torch.float32,
                      quant_scales=scales)
    assert not (bf16.pins_float32_math or int8.pins_float32_math)
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


def test_attention_backward_only_where_autograd_asks(cuda_device):
    """With grad on and an input that needs one, the output carries a grad_fn
    and backward launches the backward kernel once; under no_grad (serving)
    the forward launches alone, as before."""
    px = torch.randn(2, 16, 16, 32, device=cuda_device, requires_grad=True)
    wd = torch.randn(2, 18, 32, device=cuda_device)
    before = dict(_build.LAUNCHES)
    with torch.no_grad():
        ctx, _ = word_pixel_attention(px, wd, None, return_attn=False)
    assert ctx.grad_fn is None
    ctx, _ = word_pixel_attention(px, wd, None, return_attn=False)
    assert ctx.grad_fn is not None
    ctx.sum().backward()
    torch.cuda.synchronize()
    assert _build.LAUNCHES["word_pixel_attention"] == before["word_pixel_attention"] + 2
    assert _build.LAUNCHES["word_pixel_attention_bwd"] == before["word_pixel_attention_bwd"] + 1
    assert px.grad is not None and torch.isfinite(px.grad).all()


@pytest.mark.parametrize("cfg", [
    # (b, h, w, cin, c2, k, tanh, blend)
    (2, 128, 128, 64, 64, 3, False, False),  # h_net3.upsample + img_net3
    (2, 128, 128, 32, 64, 5, True, True),    # upscale8x + conv_output + a*srb
    (2, 12, 12, 16, 32, 5, True, False),     # ragged tiles: 24 px output
    (1, 8, 8, 32, 64, 3, False, True),       # one tile
    (1, 13, 21, 32, 64, 5, True, True),      # B = 1, 26 x 42 output: ragged both ways
    (3, 9, 17, 8, 16, 3, False, True),       # C2 16 (the narrow test tree), ragged
    (2, 256, 256, 64, 64, 3, True, False),   # x16: h_net2.upsample + img_net1, tanh, no blend
    (2, 256, 256, 32, 64, 5, True, True),    # x16: upscale8x + conv_output + a*srb, 512 px
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


@pytest.mark.parametrize("hw", [32, 128, 256])
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


@pytest.mark.parametrize("cfg", [
    # (cin, c2, k, blend): the x16 family's sites, 256 -> 512 px
    (64, 64, 3, False),  # the shared stage's last call + img_net1: tanh, no blend
    (32, 64, 5, True),   # upscale8x's second call + conv_output + a * nearest2x(srb[2])
])
def test_up_head_packed_x16_sites_bf16(cuda_device, cfg):
    """The bfloat16 tensor-core kernel at the x16 sites (B = 2, 512 px out)
    with tanh, and the same inputs without it, against its plain version:
    |err| <= 2e-2 * max(1, |ref|max) each. Weights at the scale the path
    serves (N(0, 1 / fan_in), as init_seeded draws them): with tanh the
    gate's |ref|max is at most 1, so a head whose sums run far past 1 (the
    sd 0.2 weights of the test above) would make the gate a bound on the
    saturated outputs, not on the sums; the run without tanh holds those
    sums."""
    cin, c2, k, blend = cfg
    b, h = 2, 256
    g = torch.Generator().manual_seed(cin + k)
    r = lambda *s, sd=1.0: (torch.randn(*s, generator=g) * sd).to(cuda_device)  # noqa: E731
    x = r(b, h, h, cin)
    w_up, w_head = r(3, 3, cin, c2, sd=(9 * cin) ** -0.5), r(k, k, c2 // 2, 3,
                                                             sd=(k * k * c2 / 2) ** -0.5)
    mul, add = fold_bn(1 + r(c2, sd=0.1), r(c2, sd=0.1), r(c2, sd=0.2),
                       0.5 + 1.5 * torch.rand(c2, generator=g).to(cuda_device))
    srb = r(b, 2 * h, 2 * h, 3).clamp(-1, 1).bfloat16()
    a = torch.tensor(0.5, device=cuda_device).bfloat16()
    wts = prepare_up_head_packed(w_up, mul, add, w_head, dtype=torch.bfloat16)
    xb = x.bfloat16()
    for use_tanh in (True, False):
        kw = dict(use_tanh=use_tanh, blend=blend)
        ref = packed_up_head(xb, wts, srb, a, **kw)
        before = _build.LAUNCHES["up_head_packed"]
        got = fused_up_head_packed(xb, wts, srb, a, **kw)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["up_head_packed"] == before + 1
        assert got.shape == (b, 2 * h, 2 * h, 3)
        err = (got - ref).abs().max().item()
        assert err <= 2e-2 * max(1.0, ref.abs().max().item()), (use_tanh, err)


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
    (2, 256, 256, 64, 64, 3, True, True, False),    # x16: h_net2's upsample, 512 px out
    (2, 512, 512, 32, 3, 3, False, False, False),   # x16: img_net1 at 512 px
    (2, 256, 256, 32, 64, 3, True, True, False),    # x16: upscale8x's 512 px step
    (2, 512, 512, 32, 3, 5, False, False, False),   # x16: conv_output at 512 px
    (2, 256, 256, 64, 64, 3, False, True, True),    # x16: h_net2 ResBlock conv2 at 256 px
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
    before = dict(_build.LAUNCHES)
    acc = int8_conv(x, wt, one, out_dtype=torch.float32, up2=up2)
    f32 = int8_conv(x, wt, scale, bn=affine, out_dtype=torch.float32, up2=up2)
    bf = int8_conv(x, wt, scale, bn=affine, residual=resid, up2=up2)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["int8_conv"] == before["int8_conv"] + 1
    assert _build.LAUNCHES["int8_conv_f32"] == before["int8_conv_f32"] + 2
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
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        requant(x.half(), scale)
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


# kernel launches of one forward of the x16 family at GF_DIM 32 in each path:
# attention at each of the 4 stages; the 2 up-head sites (the shared stage's
# last call, upscale8x's 512 px step); int8: 52 convs (netG 25: h_net1 6, the
# shared stage 3 x 5, the shared head 4 x 1; netGH 27), GLU-requant 8 (C 64)
# + 9 (C 32), 35 requantized inputs (every conv but the 17 ResBlock conv2s)
X16_LAUNCHES = {
    "float32": dict(word_pixel_attention=4, up_head=2),
    "bfloat16": dict(word_pixel_attention=4, up_head_packed=2),
    "int8": dict(word_pixel_attention=4, int8_conv=52, glu_requant_one=8, glu_requant_pair=9,
                 requant=35),
}


@pytest.mark.parametrize("path", ["float32", "bfloat16", "int8"])
def test_pipeline_x16_card_matches_cpu(cuda_device, path):
    """The x16 family (BRANCH_NUM 5, BASE_SIZE 8 -> 128 px, GF_DIM 32, the
    kernels' widths) on the card against the same pipeline on the CPU:
    float32 pyramid rtol 1e-3, atol 2e-4; bfloat16 >= 40 dB against float32
    on the CPU; int8 (scales calibrated on the card) >= 40 dB against the
    CPU's int8. Each forward's launches as X16_LAUNCHES; the graph replay at
    B = 2 bit for bit the eager forward, its launches the captured ones."""
    cfg = Config(TREE=TreeConfig(5, 8), GAN=GanConfig(32, 10, 2), TEXT=TextConfig(32, 6))
    sds = init_seeded(cfg, 41, torch.Generator().manual_seed(0))
    lr8, cap, lens = _serving_batch(2, seed=16)
    lr = lr8.astype(np.float32) / 127.5 - 1.0
    kw = {} if path == "float32" else dict(compute_dtype=torch.bfloat16)
    if path == "int8":
        bf16 = SRPipeline(cfg, 41, *sds, device=cuda_device, **kw)
        kw["quant_scales"] = bf16.calibrate_quant(lr, cap, lens)
    kern = SRPipeline(cfg, 41, *sds, device=cuda_device, **kw)
    plain = SRPipeline(cfg, 41, *sds, device="cpu", **({} if path == "bfloat16" else kw))
    ref = plain(lr, cap, lens)
    _build.reset_launches()
    got = kern(lr, cap, lens)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == dict(ZERO, **X16_LAUNCHES[path])
    assert tuple(got["sr"].shape) == (2, 128, 128, 3) and len(got["pyramid"]) == 4
    if path == "float32":
        for p, pr in zip(got["pyramid"], ref["pyramid"]):
            torch.testing.assert_close(p.cpu(), pr, rtol=1e-3, atol=2e-4)
    else:
        d = to_uint8(got["sr"].cpu()).double() - to_uint8(ref["sr"]).double()
        assert 10 * np.log10(255 ** 2 / max(d.square().mean().item(), 1e-12)) >= 40
    first = kern.forward_scan(lr8[None], cap[None], lens[None])[0].clone()  # captures
    _build.reset_launches()
    again = kern.forward_scan(lr8[None], cap[None], lens[None])[0]
    torch.cuda.synchronize()
    assert _build.LAUNCHES == ZERO
    assert _build.REPLAYED == dict(ZERO, **X16_LAUNCHES[path])
    eager = to_uint8(kern(torch.as_tensor(lr8, device=cuda_device).float() / 127.5 - 1.0,
                          cap, lens)["sr"])
    assert torch.equal(again, first) and torch.equal(again, eager)


# -- the float32 instances: int8 serving with float32 compute ----------------

# every int8 conv shape of the x8 forward at GF_DIM 32 (B = 2): (h, w, cin,
# cout, k, up2, bn, residual)
INT8_SITES = [
    (32, 32, 3, 64, 3, False, False, False), (32, 32, 64, 128, 3, False, True, False),
    (32, 32, 64, 64, 3, False, True, True), (32, 32, 64, 64, 3, True, True, False),
    (64, 64, 32, 3, 3, False, False, False), (64, 64, 64, 128, 3, False, True, False),
    (64, 64, 64, 64, 3, False, True, True), (64, 64, 64, 64, 3, True, True, False),
    (128, 128, 32, 3, 3, False, False, False), (128, 128, 64, 128, 3, False, True, False),
    (128, 128, 64, 64, 3, False, True, True), (128, 128, 64, 64, 3, True, True, False),
    (256, 256, 32, 3, 3, False, False, False), (32, 32, 32, 64, 3, False, True, False),
    (32, 32, 32, 32, 3, False, True, True), (32, 32, 32, 64, 3, True, True, False),
    (64, 64, 32, 3, 5, False, False, False), (64, 64, 32, 32, 3, False, True, False),
    (128, 128, 32, 3, 5, False, False, False), (256, 256, 32, 3, 5, False, False, False),
]
# the GLU-requant sites of that forward: (h, w, c)
GLU_SITE_SHAPES = [(32, 32, 64), (64, 64, 64), (128, 128, 64), (32, 32, 32), (64, 64, 32),
                   (128, 128, 32), (256, 256, 32)]


def _near_half(p, step, rel=2.0 ** -20):
    """Where p / step lies within `rel` of it of a half-integer (float64)."""
    t = (p.double() / step).abs()
    return (t - t.floor() - 0.5).abs() <= rel * t


@pytest.mark.parametrize("site", INT8_SITES)
def test_int8_conv_f32_residual_matches_plain(cuda_device, site):
    """The float32 output with a float32 residual (a quantized block's conv2
    under float32 compute) and without one, at every int8 conv shape of the
    forward: bit for bit the plain version."""
    h, w, cin, cout, k, up2, bn, res = site
    g = torch.Generator(device=cuda_device).manual_seed(h + cin + cout + k)
    x = torch.randint(-127, 128, (2, h, w, cin), generator=g, device=cuda_device,
                      dtype=torch.int8)
    wt = pack_int8_weight(torch.randint(-127, 128, (k, k, cin, cout), generator=g,
                                        device=cuda_device, dtype=torch.int8))
    scale = torch.rand(cout, generator=g, device=cuda_device) * 1e-5 + 1e-6
    affine = ((1 + 0.1 * torch.randn(cout, generator=g, device=cuda_device),
               0.1 * torch.randn(cout, generator=g, device=cuda_device)) if bn else None)
    ho, wo = (2 * h, 2 * w) if up2 else (h, w)
    resid = torch.randn(2, ho, wo, cout, generator=g, device=cuda_device) if res else None
    before = dict(_build.LAUNCHES)
    args = (x, wt, scale, affine, resid, torch.float32, up2)
    got = int8_conv(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == dict(before, int8_conv_f32=before["int8_conv_f32"] + 1)
    assert got.dtype == torch.float32 and torch.equal(got, int8_conv_plain(*args))


def test_int8_conv_f32_refusals(cuda_device):
    """A residual whose type is not the output's, and a misaligned one,
    raise before any launch."""
    x = torch.zeros(1, 8, 8, 32, dtype=torch.int8, device=cuda_device)
    wt = pack_int8_weight(torch.ones(3, 3, 32, 32, dtype=torch.int8, device=cuda_device))
    scale = torch.ones(32, device=cuda_device)
    before = dict(_build.LAUNCHES)
    with pytest.raises(TypeError, match="residual"):
        int8_conv(x, wt, scale, residual=torch.zeros(1, 8, 8, 32, device=cuda_device,
                                                    dtype=torch.bfloat16),
                  out_dtype=torch.float32)
    with pytest.raises(TypeError, match="residual"):
        int8_conv(x, wt, scale, residual=torch.zeros(1, 8, 8, 32, device=cuda_device))
    flat = torch.zeros(1 + 8 * 8 * 32, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        int8_conv(x, wt, scale, residual=flat[1:].reshape(1, 8, 8, 32), out_dtype=torch.float32)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("shape", GLU_SITE_SHAPES + [(1, 4097, 64), (1, 4097, 32)])
def test_glu_requant_f32_matches_plain(cuda_device, shape):
    """The float32 instances (c = 64 and 32) at every GLU-requant site of the
    forward (B = 2) and on a ragged row count: int8 equal to the plain
    version, except one step where p / step lies within 2^-20 of a
    half-integer (a sigmoid's last bit); the count is printed."""
    h, w, c = shape
    g = torch.Generator(device=cuda_device).manual_seed(h * w + c)
    x = 1.5 * torch.randn(2, h, w, 2 * c, generator=g, device=cuda_device)
    name = INSTANCES[c] + "_f32"
    before = dict(_build.LAUNCHES)
    got = glu_requant(x, 2.0)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == dict(before, **{name: before[name] + 1})
    ref = glu_requant_plain(x, 2.0)
    d = (got.int() - ref.int()).abs()
    p = x[..., :c] * torch.sigmoid(x[..., c:])
    print(f"{name} {shape}: {int((d > 0).sum())} of {d.numel()} differ")
    assert got.dtype == torch.int8 and d.max().item() <= 1
    assert bool(_near_half(p, act_step(2.0))[d > 0].all())


def test_glu_requant_f32_edges(cuda_device):
    """Gates at +-0, at +-100 (sigmoid 1 and 0), past expf's range (+-1e30)
    and infinite; values at exact half-steps (sigmoid 1, a power-of-two
    step: rint to even), +-0 and beyond the clip: bit for bit the plain
    version in both instances."""
    scale = 127.0 / 64  # step 2^-6
    vals = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 300.0, 0.0, -0.0], device=cuda_device) / 64
    gates = torch.tensor([100.0, 1e30, float("inf"), 0.0, -0.0, -100.0, -1e30, 3.0],
                         device=cuda_device)
    for c in sorted(INSTANCES):
        v = vals.repeat(c // 8).expand(64, c)
        gs = [gates.roll(k).repeat(c // 8).expand(64, c) for k in range(8)]
        h = torch.cat([torch.cat([v, gg], 1) for gg in gs]).contiguous()
        got = glu_requant(h, scale)
        assert torch.equal(got, glu_requant_plain(h, scale)), c
        ones = torch.cat([v, torch.full_like(v, 100.0)], 1).contiguous()  # sigmoid 1
        assert glu_requant(ones, scale)[0, :8].tolist() == [0, 2, 2, 0, -2, 127, 0, 0]


@pytest.mark.parametrize("scale", REQUANT_SCALES)
def test_requant_f32_matches_plain(cuda_device, scale):
    """The float32 flat pass against `quantize_act` bit for bit: values over
    every binade from 2^-30 to 2^10, zeros, infinities, the float32
    neighbours of every half-step; a ragged count, a view 16 bytes in; a
    view off 16-byte alignment raises."""
    g = torch.Generator(device=cuda_device).manual_seed(int(scale * 7))
    n = 1 << 18
    mag = torch.rand(n, generator=g, device=cuda_device) + 1
    expo = torch.randint(-30, 11, (n,), generator=g, device=cuda_device).float()
    sign = torch.randint(0, 2, (n,), generator=g, device=cuda_device).float() * 2 - 1
    step = act_step(scale)
    half = (torch.arange(-130, 130, device=cuda_device, dtype=torch.float64) + 0.5) * step
    half = half.float()
    x = torch.cat([mag * torch.exp2(expo) * sign, half, torch.nextafter(half, half + 1),
                   torch.nextafter(half, half - 1),
                   torch.tensor([0.0, -0.0, float("inf"), float("-inf"), 3e38, -3e38],
                                device=cuda_device)])
    before = _build.LAUNCHES["requant_f32"]
    for v in (x, x[:-3], x[4:], x[4:-5].reshape(-1, 1)):
        got = requant(v, scale)
        assert got.dtype == torch.int8 and got.shape == v.shape
        assert torch.equal(got, requant_plain(v, scale))
    assert _build.LAUNCHES["requant_f32"] == before + 4
    with pytest.raises(ValueError, match="16-byte aligned"):
        requant(x[1:], scale)
    assert _build.LAUNCHES["requant_f32"] == before + 4


def test_pipeline_int8_f32_card_matches_cpu(cuda_device):
    """int8 serving with float32 compute on the card against the same
    pipeline and scales on the CPU (GF_DIM 32): each int8 site launches the
    float32 instances (42 int8 convs, 6 + 10 GLU-requant passes, 26
    requantized inputs) and nothing of the bfloat16 ones; uint8 PSNR >= 40
    dB. The scales are recorded in float32, as cli.test --int8 records
    them."""
    cfg = Config(TREE=TreeConfig(4, 8), GAN=GanConfig(32, 10, 2), TEXT=TextConfig(32, 6))
    sds = init_seeded(cfg, 41, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    lr = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    cap = rng.integers(1, 41, (2, 6))
    cap[1, 3:] = 0
    lens = np.array([6, 3])
    f32 = SRPipeline(cfg, 41, *sds, device=cuda_device)
    scales = f32.calibrate_quant(lr, cap, lens)
    kern = SRPipeline(cfg, 41, *sds, device=cuda_device, quant_scales=scales)
    plain = SRPipeline(cfg, 41, *sds, device="cpu", quant_scales=scales)
    ref = plain(lr, cap, lens)
    _build.reset_launches()
    got = kern(lr, cap, lens)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == dict(ZERO, word_pixel_attention=3, int8_conv_f32=42,
                                   glu_requant_one_f32=6, glu_requant_pair_f32=10,
                                   requant_f32=26)
    assert got["sr"].dtype == torch.float32
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


# -- the serving engine: captured forwards and ragged shapes -----------------

# kernel launches of one forward in each serving path
PATH_LAUNCHES = {
    "float32": dict(word_pixel_attention=3, up_head=2),
    "bfloat16": dict(word_pixel_attention=3, up_head_packed=2),
    "int8": dict(word_pixel_attention=3, int8_conv=42, glu_requant_one=6, glu_requant_pair=10,
                 requant=26),
}


def _serving_batch(b, seed=0, size=8, t=6):
    """uint8 LR [b, size, size, 3], captions with mixed lengths (one empty)."""
    rng = np.random.default_rng(seed)
    lr = rng.integers(0, 256, (b, size, size, 3)).astype(np.uint8)
    lens = rng.integers(1, t + 1, b)
    lens[0] = 0
    cap = rng.integers(1, 41, (b, t))
    cap[np.arange(t)[None, :] >= lens[:, None]] = 0
    return lr, cap, lens


def _serving_pipe(device, path):
    """A narrow x8 pipeline on the card in `path` (int8 at GF_DIM 32, the
    kernel's GLU widths, with scales calibrated on the card's bf16
    pipeline)."""
    cfg = Config(TREE=TreeConfig(4, 8), GAN=GanConfig(32 if path == "int8" else 8, 10, 2),
                 TEXT=TextConfig(32, 6))
    sds = init_seeded(cfg, 41, torch.Generator().manual_seed(0))
    kw = {} if path == "float32" else dict(compute_dtype=torch.bfloat16)
    if path == "int8":
        lr, cap, lens = _serving_batch(4, seed=9)
        bf16 = SRPipeline(cfg, 41, *sds, device=device, **kw)
        kw["quant_scales"] = bf16.calibrate_quant(lr / 127.5 - 1.0, cap, lens)
    return SRPipeline(cfg, 41, *sds, device=device, **kw)


@pytest.mark.parametrize("b", [1, 3, 64])
@pytest.mark.parametrize("path", ["float32", "bfloat16", "int8"])
def test_graph_replay_equals_eager(cuda_device, path, b):
    """forward_scan (uint8 LR) and sr_uint8 (float LR) replay the forward
    captured at graph_batch(B) (B = 3 at 4, padded by replicas), bit for
    bit the uint8 of the eager __call__ on the same padded inputs, cropped
    to B; a replay launches nothing eagerly and counts the captured
    launches in REPLAYED."""
    pipe = _serving_pipe(cuda_device, path)
    lr, cap, lens = _serving_batch(b)
    g = SRPipeline.graph_batch(b)
    first = pipe.forward_scan(lr[None], cap[None], lens[None])[0].clone()  # captures
    lrf = torch.as_tensor(lr, device=cuda_device).float() / 127.5 - 1.0
    pipe.sr_uint8(lrf.cpu().numpy(), cap, lens)  # captures the float32 graph
    _build.reset_launches()
    got = pipe.forward_scan(lr[None], cap[None], lens[None])[0]
    got_f = pipe.sr_uint8(lrf.cpu().numpy(), cap, lens)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == ZERO
    assert _build.REPLAYED == {k: 2 * v for k, v in dict(ZERO, **PATH_LAUNCHES[path]).items()}
    assert pipe.graphs[(g, 8, 8, 6, torch.uint8)].launches == dict(ZERO, **PATH_LAUNCHES[path])
    assert list(pipe.graphs) == [(g, 8, 8, 6, torch.uint8), (g, 8, 8, 6, torch.float32)]
    sel = np.arange(g) % b
    ref = to_uint8(pipe(lrf[sel], cap[sel], lens[sel])["sr"])[:b]
    assert torch.equal(got, ref) and torch.equal(first, got)
    ref_f = to_uint8(pipe(lrf.cpu().numpy()[sel], cap[sel], lens[sel])["sr"])[:b]
    assert np.array_equal(got_f, ref_f.cpu().numpy())


def test_second_graph_leaves_the_first(cuda_device):
    """A forward_scan at a new B captures a second graph in the same pool;
    the first graph's output survives the second's replay, and its next
    replay gives the same bits."""
    pipe = _serving_pipe(cuda_device, "bfloat16")
    lr2, cap2, lens2 = _serving_batch(2)
    lr3, cap3, lens3 = _serving_batch(3, seed=1)
    a = pipe.forward_scan(lr2[None], cap2[None], lens2[None])
    pipe.forward_scan(lr3[None], cap3[None], lens3[None])
    assert sorted(k[0] for k in pipe.graphs) == [2, 4]  # B = 3 replays at 4
    g2 = pipe.graphs[(2, 8, 8, 6, torch.uint8)]
    torch.cuda.synchronize()
    assert torch.equal(g2.out, a[0])
    again = pipe.forward_scan(lr2[None], cap2[None], lens2[None])
    assert torch.equal(again, a) and g2.replays == 2


def test_plan_microbatch_takes_jax_arguments(cuda_device):
    """`budget_bytes` replaces the measured budget, `hi` caps the plan and
    `quantum` sets the probes; a budget below what lo needs raises."""
    pipe = _serving_pipe(cuda_device, "bfloat16")
    default = pipe.plan_microbatch()
    probes = dict(pipe.memory_plan.probes)
    capped = pipe.plan_microbatch(budget_bytes=pipe.memory_plan.budget_bytes, hi=48)
    assert capped == 32 and pipe.memory_plan.budget_bytes > 0 and default >= 256
    fixed, per_image = pipe.memory_plan.fixed_bytes, pipe.memory_plan.per_image_bytes
    budget = memory.GRAPH_COPIES * (fixed + per_image * 100) + \
        pipe.memory_plan.held_per_image_bytes * 100
    b = pipe.plan_microbatch(budget_bytes=budget, quantum=32)
    assert pipe.memory_plan.budget_bytes == budget and sorted(pipe.memory_plan.probes) == [32, 128]
    assert 32 <= b <= 128 and b % 32 == 0
    with pytest.raises(RuntimeError, match="at least"):
        pipe.plan_microbatch(budget_bytes=1, lo=8)
    assert sorted(probes) == [64, 256]


def test_sr_batched_keeps_few_graphs(cuda_device):
    """sr_batched(microbatch=None) at every N = 1..200 (one microbatch of N
    each) captures ten graphs, at 1, 2, 4, ..., 64, 128, 192 and 256, and
    each N's result is the eager forward at its graph batch, cropped."""
    pipe = _serving_pipe(cuda_device, "bfloat16")
    lr, cap, lens = _serving_batch(200, seed=3)
    outs = {n: pipe.sr_batched(lr[:n], cap[:n], lens[:n]) for n in range(1, 201)}
    assert pipe.plan_microbatch() >= 256
    assert sorted(k[0] for k in pipe.graphs) == [1, 2, 4, 8, 16, 32, 64, 128, 192, 256]
    lrf = torch.as_tensor(lr, device=cuda_device).float() / 127.5 - 1.0
    for n in (1, 3, 64, 65, 200):
        sel = np.arange(SRPipeline.graph_batch(n)) % n
        ref = to_uint8(pipe(lrf[:n][sel], cap[:n][sel], lens[:n][sel])["sr"])[:n]
        assert np.array_equal(outs[n], ref.cpu().numpy()), n


def test_graph_cache_drops_least_recent(cuda_device, monkeypatch):
    """Past MAX_GRAPHS the least recently replayed graph goes; the kept
    ones and a new capture in the freed room give the same bits as
    before."""
    monkeypatch.setattr(inference, "MAX_GRAPHS", 2)
    pipe = _serving_pipe(cuda_device, "bfloat16")
    lr, cap, lens = _serving_batch(4, seed=4)

    def run(b):
        return pipe.forward_scan(lr[None, :b], cap[None, :b], lens[None, :b])[0].clone()

    one, two = run(1), run(2)
    assert torch.equal(run(1), one)  # 1 is now the most recent
    four = run(4)
    assert [k[0] for k in pipe.graphs] == [1, 4]
    assert torch.equal(run(1), one) and torch.equal(run(2), two)  # 2 captured again, 4 dropped
    assert [k[0] for k in pipe.graphs] == [1, 2]
    assert torch.equal(run(4), four)


def test_threads_share_one_pipeline(cuda_device):
    """Two threads x 16 sr_uint8 calls with different inputs at the same
    graph keys (B = 1 and B = 3, which replays at 4), a third thread's
    sr_arbitrary calls at the same time, and one call that captures a new
    key (B = 2) while the others run: every result bit for bit the same call
    run alone afterwards (SRPipeline.lock)."""
    import threading

    pipe = _serving_pipe(cuda_device, "bfloat16")
    jobs = {}
    for k in range(2):
        for i in range(16):
            b = 2 if (k, i) == (0, 8) else 1 + 2 * (i % 2)
            lr, cap, lens = _serving_batch(b, seed=1000 * k + i)
            cap[0, :3], lens[0] = (5, 6, 7 + i), 3  # row 0's caption is not empty
            jobs[k, i] = ("sr_uint8", (lr / 127.5 - 1.0).astype(np.float32), cap, lens)
    rng = np.random.default_rng(7)
    for i in range(6):
        _, cap, lens = _serving_batch(1, seed=3000 + i)
        cap[0, :2], lens[0] = (9, 10 + i), 2
        lr = rng.integers(0, 256, (1, 12, 20, 3)) / 127.5 - 1.0
        jobs[2, i] = ("sr_arbitrary", lr.astype(np.float32), cap, lens)

    def run(job):
        name, lr, cap, lens = job
        return getattr(pipe, name)(lr, cap, lens)

    pipe.sr_uint8(*jobs[0, 0][1:])  # the B = 1 graph exists before the threads start
    got, errors = {}, []
    start = threading.Barrier(3)

    def worker(k):
        try:
            start.wait(30)
            for key in sorted(j for j in jobs if j[0] == k):
                got[key] = run(jobs[key])
        except Exception as e:  # reported below, with the thread's jobs
            errors.append((k, e))

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert sorted(k[0] for k in pipe.graphs) == [1, 2, 4]
    for key, job in jobs.items():
        assert np.array_equal(got[key], run(job)), key


def _ragged_attention(device, hw, dtype):
    """Attention at a ragged sr_arbitrary site (B = 1, C 32, T 18)."""
    rng = np.random.default_rng(hw[0])
    px = torch.from_numpy(rng.normal(size=(1, *hw, 32)).astype(np.float32)).to(device)
    wd = torch.from_numpy(rng.normal(size=(1, 18, 32)).astype(np.float32)).to(device)
    mask = (torch.arange(18) >= 7)[None].to(device)
    ctx_k, attn_k = word_pixel_attention(px.to(dtype), wd.to(dtype), mask)
    ctx_p, attn_p = plain_wpa(px.to(dtype).float(), wd.to(dtype).float(), mask)
    torch.cuda.synchronize()
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=2 ** -8, atol=1e-5)
    torch.testing.assert_close(ctx_k.float(), ctx_p, **tol)
    torch.testing.assert_close(attn_k.float(), attn_p, **tol)


# the kernel sites of sr_arbitrary at a 40 x 56 LR, full width (B = 1): the
# attention's three pixel grids, both up-head sites (160 x 224 -> 320 x 448),
# and the int8 convs' shapes (b, h, w, cin, cout, k, up2, bn, residual)
RAGGED_SITES = (
    [("attention", (hw, dt)) for hw in ((40, 56), (80, 112), (160, 224))
     for dt in (torch.float32, torch.bfloat16)]
    + [(kind, (1, 160, 224, cin, 64, k, k == 5, k == 5)) for kind in ("up_head", "up_head_packed")
       for cin, k in ((64, 3), (32, 5))]
    + [("int8_conv", cfg) for cfg in (
        (1, 40, 56, 3, 64, 3, False, False, False),
        (1, 40, 56, 64, 128, 3, False, True, False),
        (1, 40, 56, 64, 64, 3, False, True, True),
        (1, 40, 56, 64, 64, 3, True, True, False),
        (1, 80, 112, 32, 3, 3, False, False, False),
        (1, 40, 56, 32, 64, 3, False, True, False),
        (1, 40, 56, 32, 32, 3, False, True, True),
        (1, 80, 112, 32, 64, 3, True, True, False),
        (1, 160, 224, 32, 3, 5, False, False, False),
        (1, 320, 448, 32, 3, 3, False, False, False),
        (1, 320, 448, 32, 3, 5, False, False, False))])


@pytest.mark.parametrize("site", RAGGED_SITES, ids=lambda s: f"{s[0]}-{s[1]}")
def test_sr_arbitrary_ragged_site_matches_plain(cuda_device, site):
    """Each kernel site of sr_arbitrary at a ragged LR (40 x 56, whose
    grids are not multiples of the kernels' tiles) against its plain
    version, with the gate of that kernel's own test."""
    kind, cfg = site
    if kind == "attention":
        _ragged_attention(cuda_device, *cfg)
    elif kind == "up_head":
        test_up_head_kernel_matches_plain(cuda_device, cfg)
    elif kind == "up_head_packed":
        test_up_head_packed_kernel_matches_plain(cuda_device, cfg, torch.bfloat16)
    else:
        test_int8_conv_matches_plain(cuda_device, cfg)


# -- the eval CLI on the card --------------------------------------------------

CLI_YAML = """CONFIG_NAME: 'narrow_face'
DATASET_NAME: 'face'
TREE:
    BRANCH_NUM: 4
    BASE_SIZE: 8
TRAIN:
    FLAG: False
    NET_G: 'absent/netG_epoch_7.pth'
GAN:
    GF_DIM: 32
    CONDITION_DIM: 10
TEXT:
    EMBEDDING_DIM: 32
    WORDS_NUM: 6
    CAPTIONS_PER_IMAGE: 1
"""


@pytest.mark.parametrize("mode", ["bf16", "f32_int8"])
def test_cli_test_runs_on_the_card(cuda_device, tmp_path, mode):
    """tgsr_tpu_torch.cli.test at small N on the card (2 PNGs in the face
    layout, GF_DIM 32 so that the GLU widths are the kernels' 64 and 32,
    seeded .pth, the seeded text encoder): each SR and attention grid
    written, through rows 1 and 3 (bf16 default) or through the float32
    instances of rows 8, 9, X1 and X2 (--no-bf16 --int8)."""
    from tgsr_tpu_torch.cli import test as cli
    from tgsr_tpu_torch.data.codec import decode_png, encode_png

    img_dir = tmp_path / "data" / "Img" / "changetxt_im1"
    img_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    names = ("Smiling Male Young " + " ".join(f"a{i}" for i in range(37))).split()
    with open(tmp_path / "data" / "testset.txt", "w") as f:
        f.write(" ".join(names) + " \n")
        for i, row in enumerate(([1] + [0] * 39, [0, 1] + [0] * 38)):
            f.write(f"{i:06d}.jpg " + " ".join(map(str, row)) + "\n")
            (img_dir / f"{i:06d}.png").write_bytes(
                encode_png(rng.integers(0, 256, (70, 66, 3)).astype(np.uint8)))
    (tmp_path / "cfg.yml").write_text(CLI_YAML)
    cfg = cli.load_config(str(tmp_path / "cfg.yml"))
    sds = init_seeded(cfg, 3, torch.Generator().manual_seed(0))
    for name, sd in (("netG_epoch_7.pth", sds[1]), ("netGH_epoch_7.pth", sds[2])):
        torch.save(sd, tmp_path / name)
    _build.reset_launches()
    summary = cli.main(["--cfg", str(tmp_path / "cfg.yml"), "--data_dir", str(tmp_path / "data"),
                        "--ckpt_dir", str(tmp_path), "--out_dir", str(tmp_path / "out")]
                       + (["--no-bf16", "--int8"] if mode == "f32_int8" else []))
    torch.cuda.synchronize()
    assert summary["images"] == summary["grids"] == 2
    for i in range(2):
        sr = decode_png((tmp_path / "out" / "testset" / f"{i:06d}_SR.png").read_bytes())
        grid = decode_png((tmp_path / "out" / "testset" / "att" / f"{i:06d}.png").read_bytes())
        assert sr.shape == (64, 64, 3) and grid.shape == (306, 258, 3)
    used = {k for k, v in _build.LAUNCHES.items() if v}
    if mode == "bf16":
        assert {"word_pixel_attention", "up_head_packed"} <= used
    else:
        assert {"word_pixel_attention", "int8_conv_f32", "glu_requant_one_f32",
                "glu_requant_pair_f32", "requant_f32"} <= used
        assert not used & {"int8_conv", "glu_requant_one", "glu_requant_pair", "requant"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gan_trainer_step_card_matches_cpu(cuda_device, dtype):
    """One GANTrainer step at a narrow x8 tree (BASE_SIZE 8, GF_DIM 16,
    DF_DIM 16), the same init and batch on the card and on the CPU: the card
    goes through the attention kernel forward and backward (3 each), and
    every metric agrees within rtol 1e-4 in float32 (TF32 off; sums in
    another order), 5e-2 in bfloat16 (both sides bfloat16, rounded at other
    places)."""
    from tgsr_tpu_torch.checkpoints.from_jax import seeded_text_state_dict
    from tgsr_tpu_torch.config import EvalConfig
    from tgsr_tpu_torch.engine.gan_trainer import GANTrainer

    cfg = Config(TREE=TreeConfig(4, 8), GAN=GanConfig(16, 10, 2, DF_DIM=16),
                 TEXT=TextConfig(32, 6), EVAL=EvalConfig())
    text_sd = seeded_text_state_dict(cfg, 12, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(0)
    caps = rng.integers(1, 12, (3, 6))
    caps[1, 3:] = 0
    caps[2, :] = 0
    b = {"lr": rng.uniform(-1, 1, (3, 8, 8, 3)).astype(np.float32),
         "real_pyramid": [rng.uniform(-1, 1, (3, s, s, 3)).astype(np.float32) for s in (16, 32, 64)],
         "captions": caps, "cap_lens": np.array([6, 3, 0])}
    metrics = {}
    for device in ("cpu", cuda_device):
        t = GANTrainer(cfg, 12, text_sd, compute_dtype=dtype, device=device)
        s = t.init_state(torch.Generator().manual_seed(0))
        before = dict(_build.LAUNCHES)
        metrics[str(device)] = {k: float(v) for k, v in t.train_step(s, b).items()}
        launched = {k: _build.LAUNCHES[k] - before[k] for k in before}
    assert launched["word_pixel_attention"] == 3 and launched["word_pixel_attention_bwd"] == 3
    rtol = 1e-4 if dtype == torch.float32 else 5e-2
    for k, v in metrics["cpu"].items():
        np.testing.assert_allclose(metrics[str(cuda_device)][k], v, rtol=rtol, err_msg=k)


def test_plan_batch_on_the_card(cuda_device):
    """GANTrainer.plan_batch on the card at a narrow x16 tree (BASE_SIZE 8,
    GF_DIM 16, DF_DIM 16, remat 'all') with a 1 GiB budget and hi 64: a
    positive multiple of 8 whose probe completed under the budget, a fresh
    run at the answer completes with the allocator capped at the budget,
    and the allocator's memory fraction is as it was after."""
    from tgsr_tpu_torch.checkpoints.from_jax import seeded_text_state_dict
    from tgsr_tpu_torch.config import EvalConfig
    from tgsr_tpu_torch.engine.gan_trainer import GANTrainer

    cfg = Config(TREE=TreeConfig(5, 8), GAN=GanConfig(16, 10, 2, DF_DIM=16),
                 TEXT=TextConfig(32, 6), EVAL=EvalConfig())
    t = GANTrainer(cfg, 12, seeded_text_state_dict(cfg, 12, torch.Generator().manual_seed(3)),
                   remat="all", device=cuda_device)
    budget, index = 2 ** 30, torch.cuda.current_device()
    before = torch.cuda.get_per_process_memory_fraction(index)
    b = t.plan_batch(budget_bytes=budget, hi=64)
    probes = t.batch_plan["probes"]
    assert 0 < b <= 64 and b % 8 == 0 and probes[b] is not None and probes[b] <= budget
    assert all(need is None or need > budget for k, need in probes.items() if k > b)
    assert t.step_peak_bytes(b, budget) is not None
    assert torch.cuda.get_per_process_memory_fraction(index) == before


def _damsm_cfg():
    import dataclasses

    from tgsr_tpu_torch.config import EvalConfig, SmoothConfig, TrainConfig

    return Config(TREE=TreeConfig(1, 64), TEXT=TextConfig(32, 6), EVAL=EvalConfig(),
                  TRAIN=dataclasses.replace(TrainConfig(), ENCODER_LR=2e-3,
                                            SMOOTH=SmoothConfig(4.0, 5.0, 10.0)))


@pytest.mark.parametrize("family", ["simple", "inception"])
def test_damsm_step_card_matches_cpu(cuda_device, family):
    """One DAMSMTrainer step at B = 4 (64 px images, nef 32, T 6), the same
    seeded init, batch and dropout on the card and on the CPU: metrics
    within rtol 1e-4, each trainable gradient (Adam's first moment) within
    relative L2 1e-3 (the CNN's float32 convolutions in another order, and
    for SimpleCNN its train-mode BN backward), the BN running stats within
    1e-4 (|x| + 1)."""
    from tgsr_tpu_torch.engine.damsm_trainer import DAMSMTrainer

    cfg = _damsm_cfg()
    rng = np.random.default_rng(1)
    caps = rng.integers(1, 12, (4, 6))
    caps[1, 3:] = 0
    caps[2, 1:] = 0
    b = {"hr": rng.integers(0, 256, (4, 64, 64, 3)).astype(np.uint8), "captions": caps,
         "cap_lens": np.array([6, 3, 1, 6]), "class_ids": np.arange(4)}
    out = {}
    for device in ("cpu", cuda_device):
        t = DAMSMTrainer(cfg, 12, use_inception=family == "inception", seed=5, device=device)
        s = t.init_state(torch.Generator().manual_seed(0))
        m = t.train_step(s, t.device_batch(b), t.epoch_lr(0))
        grads = {n: s.opt.state[p]["exp_avg"].cpu() for n, p in t.trainable(s.text, s.cnn)}
        stats = {k: v.cpu() for k, v in s.cnn.state_dict().items() if "running" in k}
        out[str(device)] = ({k: float(v) for k, v in m.items()}, grads, stats)
    (mc, gc, sc), (mg, gg, sg) = out["cpu"], out[str(cuda_device)]
    for k, v in mc.items():
        np.testing.assert_allclose(mg[k], v, rtol=1e-4, err_msg=k)
    for n, ref in gc.items():
        rel = ((gg[n] - ref).norm() / ref.norm().clamp(min=1e-30)).item()
        assert rel <= 1e-3, (n, rel)
    for k, ref in sc.items():
        assert ((sg[k] - ref).abs() <= 1e-4 * (ref.abs() + 1)).all(), k


def _damsm_gan(device, image_encoder):
    from tgsr_tpu_torch.checkpoints.from_jax import seeded_text_state_dict
    from tgsr_tpu_torch.config import EvalConfig
    from tgsr_tpu_torch.engine.gan_trainer import GANTrainer

    cfg = Config(TREE=TreeConfig(4, 8), GAN=GanConfig(16, 10, 2, DF_DIM=16),
                 TEXT=TextConfig(32, 6), EVAL=EvalConfig())
    text_sd = seeded_text_state_dict(cfg, 12, torch.Generator().manual_seed(3))
    t = GANTrainer(cfg, 12, text_sd, image_encoder=image_encoder, device=device)
    return t, t.init_state(torch.Generator().manual_seed(0))


def _damsm_gan_batch():
    rng = np.random.default_rng(2)
    caps = rng.integers(1, 12, (3, 6))
    caps[1, 3:] = 0
    return {"lr": rng.uniform(-1, 1, (3, 8, 8, 3)).astype(np.float32),
            "real_pyramid": [rng.uniform(-1, 1, (3, s, s, 3)).astype(np.float32)
                             for s in (16, 32, 64)],
            "captions": caps, "cap_lens": np.array([6, 3, 6]), "class_ids": np.array([0, 1, 0])}


def _simple_encoder():
    from tgsr_tpu_torch.checkpoints.from_jax import seeded_cnn_encoder_state_dict
    from tgsr_tpu_torch.models.image_encoder import SimpleCNNEncoder

    enc = SimpleCNNEncoder(32)
    enc.load_state_dict(seeded_cnn_encoder_state_dict(True, 32, torch.Generator().manual_seed(4)))
    return enc


def test_gan_step_with_damsm_terms_card_matches_cpu(cuda_device):
    """A GANTrainer step with SimpleCNNEncoder's DAMSM terms (narrow x8
    tree), card against CPU: 3 + 3 attention launches, every metric (w_loss
    and s_loss among them) within rtol 1e-4, float32, TF32 off."""
    import copy

    enc = _simple_encoder()
    b = _damsm_gan_batch()
    metrics = {}
    for device in ("cpu", cuda_device):
        t, s = _damsm_gan(device, copy.deepcopy(enc))
        before = dict(_build.LAUNCHES)
        metrics[str(device)] = {k: float(v) for k, v in t.train_step(s, b).items()}
        launched = {k: _build.LAUNCHES[k] - before[k] for k in before}
    assert launched["word_pixel_attention"] == 3 and launched["word_pixel_attention_bwd"] == 3
    assert {"w_loss", "s_loss"} <= set(metrics["cpu"])
    for k, v in metrics["cpu"].items():
        np.testing.assert_allclose(metrics[str(cuda_device)][k], v, rtol=1e-4, err_msg=k)


def test_attention_backward_through_the_damsm_gradient(cuda_device):
    """G's gradient of the DAMSM terms alone (generator_loss with no
    discriminator, SimpleCNNEncoder on the finest fake) reaches every
    attention site through the backward kernel (3 launches) and equals the
    CPU's within relative L2 1e-3 per tensor."""
    import copy

    from tgsr_tpu_torch.losses.gan import generator_loss

    enc = _simple_encoder()
    b = _damsm_gan_batch()
    grads = {}
    for device in ("cpu", cuda_device):
        t, s = _damsm_gan(device, copy.deepcopy(enc))
        lr, words, sent, mask = t._inputs(b)
        _, fine, _, _ = t._generate(s, lr, words, sent, mask)
        loss, logs = generator_loss([], t._encode, fine, sent, words,
                                    torch.as_tensor(b["cap_lens"], device=device), None)
        names, params = zip(*s.g_named_parameters())
        before = _build.LAUNCHES["word_pixel_attention_bwd"]
        g = torch.autograd.grad(loss, params, allow_unused=True)
        launched = _build.LAUNCHES["word_pixel_attention_bwd"] - before
        grads[str(device)] = {n: x.cpu() for n, x in zip(names, g) if x is not None}
    assert launched == 3
    assert grads["cpu"].keys() == grads[str(cuda_device)].keys()
    assert any("att" in n for n in grads["cpu"])
    for n, ref in grads["cpu"].items():
        rel = ((grads[str(cuda_device)][n] - ref).norm() / ref.norm().clamp(min=1e-30)).item()
        assert rel <= 1e-3, (n, rel)


# -- the custom ops and exported serving programs ------------------------------

def _op_cases(device):
    """(op, args on the card, the plain version of the same function, the
    comparison) of each tgsr:: op at a main-path shape."""
    g = torch.Generator(device=device).manual_seed(17)
    r = lambda *s, sd=1.0: torch.randn(*s, generator=g, device=device) * sd  # noqa: E731
    px, wd = r(2, 32, 32, 32), r(2, 18, 32)
    mask = torch.zeros(2, 18, dtype=torch.bool, device=device)
    mask[1, 7:] = True
    gctx, gattn = r(2, 32, 32, 32), r(2, 18, 32, 32)
    w_up, w_head = r(3, 3, 32, 64, sd=0.2), r(5, 5, 32, 3, sd=0.2)
    mul, add = 1 + r(64, sd=0.1), r(64, sd=0.1)
    x, srb, a = r(2, 64, 64, 32), r(2, 128, 128, 3), torch.tensor(0.3, device=device)
    pk = prepare_up_head_packed(w_up, mul, add, w_head, dtype=torch.bfloat16)
    xq = torch.randint(-127, 128, (2, 32, 32, 64), generator=g, device=device, dtype=torch.int8)
    wq = pack_int8_weight(torch.randint(-127, 128, (3, 3, 64, 128), generator=g, device=device,
                                        dtype=torch.int8))
    scale = torch.rand(128, generator=g, device=device) * 1e-5 + 1e-6
    h = (1.5 * r(2, 32, 32, 128)).bfloat16()
    pw = pack_phase_weight(torch.randint(-127, 128, (2, 2, 64, 256), generator=g, device=device,
                                         dtype=torch.int8))

    def close(tol):
        return lambda got, ref: torch.testing.assert_close(got, ref, rtol=tol, atol=tol)

    def bwd_plain(p, w, m, gc, ga):
        p, w = p.clone().requires_grad_(), w.clone().requires_grad_()
        ctx, att = plain_wpa(p, w, m, True)
        return torch.autograd.grad((ctx, att), (p, w), (gc, ga))

    def int8_steps(got, ref):
        d = (got.int() - ref.int()).abs()
        assert d.max().item() <= 1 and (d > 0).double().mean().item() <= 1e-3

    return {
        "word_pixel_attention": (torch.ops.tgsr.word_pixel_attention, (px, wd, mask, True),
                                 lambda *a: plain_wpa(*a), close(1e-5)),
        "word_pixel_attention_bwd": (torch.ops.tgsr.word_pixel_attention_bwd,
                                     (px, wd, mask, gctx, gattn), bwd_plain,
                                     lambda got, ref: (got - ref).abs().max() <= 1e-5 * max(
                                         1.0, ref.abs().max().item())),
        "up_head": (torch.ops.tgsr.up_head,
                    (x, w_up, mul, add, w_head, None, srb, a, True, True),
                    lambda x, w_up, mul, add, w_head, _, srb, a, t, bl: reference_up_head(
                        x, w_up, mul, add, w_head, srb, a, use_tanh=t, blend=bl), close(1e-4)),
        "up_head_packed": (torch.ops.tgsr.up_head_packed,
                           (x.bfloat16(), *pk, srb.bfloat16(), a.bfloat16(), True, True),
                           lambda x, *w: packed_up_head(x, type(pk)(*w[:4]), w[6], w[7],
                                                        use_tanh=w[8], blend=w[9]),
                           lambda got, ref: (got - ref).abs().max() <= 2e-2 * max(
                               1.0, ref.abs().max().item())),
        "int8_conv": (torch.ops.tgsr.int8_conv,
                      (xq, wq.q, wq.packed, scale, mul[:1].expand(128).contiguous(),
                       add[:1].expand(128).contiguous(), None, torch.float32, False),
                      lambda x, q, p, s, bm, ba, res, dt, up2: int8_conv_plain(
                          x, type(wq)(q, p), s, (bm, ba), res, dt, up2),
                      lambda got, ref: torch.equal(got, ref)),
        "glu_requant": (torch.ops.tgsr.glu_requant, (h, 3.0), glu_requant_plain, int8_steps),
        "requant": (torch.ops.tgsr.requant, (h, 3.0), requant_plain,
                    lambda got, ref: torch.equal(got, ref)),
        "int8_upconv_phases": (torch.ops.tgsr.int8_upconv_phases,
                               (xq, pw.q, pw.packed, scale.repeat(2), mul, add, 3.0,
                                torch.bfloat16),
                               lambda x, q, p, s, bm, ba, o, dt: int8_upconv_plain(
                                   x, type(pw)(q, p), s, (bm, ba), o, dt),
                               lambda got, ref: torch.equal(got, ref)),
    }


@pytest.mark.parametrize("name", ["word_pixel_attention", "word_pixel_attention_bwd", "up_head",
                                  "up_head_packed", "int8_conv", "glu_requant", "requant",
                                  "int8_upconv_phases"])
def test_custom_op_matches_plain_and_fake(cuda_device, name):
    """Each tgsr:: op on the card, called through torch.ops, against its
    plain version on the same inputs (the gates of the kernels' own tests),
    and its fake implementation against the real outputs' shapes, dtypes
    and strides, with the op's schema (no input mutated or aliased)
    checked by `torch.library.opcheck`."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    op, args, plain, compare = _op_cases(cuda_device)[name]
    got = op(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
    for gt, rt in zip(got, ref):
        ok = compare(gt, rt.to(gt.dtype) if gt.dtype != rt.dtype and gt.is_floating_point()
                     else rt)
        assert ok is None or ok
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(t) if torch.is_tensor(t) else t for t in args))
    fake = fake if isinstance(fake, tuple) else (fake,)
    for f, gt in zip(fake, got):
        assert (f.shape, f.dtype, f.stride()) == (gt.shape, gt.dtype, gt.stride())
    torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor"))


def _aot_pipe(device, path, tmp_path):
    """A narrow x8 card pipeline in `path` and its exported program, loaded
    as an AOTPipeline."""
    from tgsr_tpu_torch.engine import aot

    pipe = _serving_pipe(device, path)
    art = aot.export_serving(pipe, str(tmp_path / path))
    return pipe, aot.AOTPipeline(art, device=device)


@pytest.mark.parametrize("b", [1, 3, 64])
@pytest.mark.parametrize("path", ["float32", "bfloat16", "int8"])
def test_aot_replay_equals_eager(cuda_device, path, b, tmp_path):
    """A loaded artifact replays the program captured at graph_batch(B),
    bit for bit its eager run on the same padded inputs, cropped, and the
    live pipeline's replay; its launches per forward are the live path's."""
    pipe, ap = _aot_pipe(cuda_device, path, tmp_path)
    lr, cap, lens = _serving_batch(b, seed=b)
    lrf = lr.astype(np.float32) / 127.5 - 1.0
    g = SRPipeline.graph_batch(b)
    ap.sr_uint8(lrf, cap, lens)  # captures
    _build.reset_launches()
    got = ap.sr_uint8(lrf, cap, lens)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == ZERO
    assert _build.REPLAYED == dict(ZERO, **PATH_LAUNCHES[path])
    assert list(ap.graphs) == [(g, 6)]
    sel = np.arange(g) % b
    with torch.inference_mode():
        eager = ap.module(torch.as_tensor(lrf[sel], device=cuda_device),
                          torch.as_tensor(cap[sel], device=cuda_device),
                          torch.as_tensor(lens[sel], device=cuda_device))[:b]
    assert np.array_equal(got, eager.cpu().numpy())
    assert np.array_equal(got, pipe.sr_uint8(lrf, cap, lens))


def test_float32_artifact_turns_tf32_off(cuda_device, tmp_path):
    """A float32 artifact (face S8 at full width, seeded weights) loaded with
    TF32 switched on beforehand turns it off, as a float32 SRPipeline does,
    and gives, bit for bit, the artifact loaded with TF32 off and the live
    pipeline."""
    from tgsr_tpu_torch.config import face_s8_config
    from tgsr_tpu_torch.engine import aot

    cfg = face_s8_config()
    pipe = SRPipeline(cfg, 41, *init_seeded(cfg, 41, torch.Generator().manual_seed(0)),
                      device=cuda_device)
    art = aot.export_serving(pipe, str(tmp_path / "f32"))
    rng = np.random.default_rng(6)
    lr = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    cap = rng.integers(1, 41, (4, 18))
    lens = np.array([18, 7, 0, 12])
    cap[np.arange(18)[None, :] >= lens[:, None]] = 0
    out = {}
    for on in (True, False):
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
        ap = aot.AOTPipeline(art, device=cuda_device)
        assert ap.pins_float32_math
        assert not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32)
        out[on] = ap.sr_uint8(lr, cap, lens)
    assert np.array_equal(out[True], out[False])
    assert np.array_equal(out[True], pipe.sr_uint8(lr, cap, lens))


# -- the EVAL switches: rows 2 and 3 blending a weight map, the variant paths --------------

@pytest.mark.parametrize("shape", [(3, 24, 40), (2, 128, 128)])
@pytest.mark.parametrize("row", ["up_head", "up_head_packed float32", "up_head_packed bfloat16"])
def test_up_head_weight_map_matches_plain(cuda_device, row, shape):
    """Rows 2 and 3 at the weight-map site (Cin 32, C2 64, 5 x 5 head, tanh,
    + a3 * srb) with a [2H, 2W] map read per output pixel, against their plain
    versions (row 2 and row 3 float32 1e-4, row 3 bfloat16 2e-2 of max(1,
    |ref|max)); 24 x 40 leaves partial tiles. A map of one value gives the
    scalar's bits, and a map of another size is refused."""
    b, h, w = shape
    cin, c2, k = 32, 64, 5
    g = torch.Generator().manual_seed(h + w)
    r = lambda *s, sd=1.0: (torch.randn(*s, generator=g) * sd).to(cuda_device)  # noqa: E731
    x, w_up, w_head = r(b, h, w, cin), r(3, 3, cin, c2, sd=0.2), r(k, k, c2 // 2, 3, sd=0.05)
    mul, add = fold_bn(1 + r(c2, sd=0.1), r(c2, sd=0.1), r(c2, sd=0.1),
                       (1 + r(c2, sd=0.2)).abs())
    srb = r(b, 2 * h, 2 * w, 3)
    amap = (1 + torch.rand(2 * h, 2 * w, generator=g) - 0.5).to(cuda_device)
    kw = dict(use_tanh=True, blend=True)
    if row == "up_head":
        wts = prepare_up_head(w_up, mul, add, w_head)
        ref = reference_up_head(x, w_up, mul, add, w_head, srb, amap, **kw)
        run = lambda a: up_head_folded(wts, x, srb, a, **kw)  # noqa: E731
        dtype, gate = torch.float32, 1e-4
    else:
        dtype = torch.float32 if row.endswith("float32") else torch.bfloat16
        gate = 1e-4 if dtype == torch.float32 else 2e-2
        wts = prepare_up_head_packed(w_up, mul, add, w_head, dtype=dtype)
        xs, srb = x.to(dtype), srb.to(dtype)
        ref = packed_up_head(xs, wts, srb, amap.to(dtype), **kw)
        run = lambda a: fused_up_head_packed(xs, wts, srb, a.to(dtype), **kw)  # noqa: E731
    name = row.split()[0]
    before = _build.LAUNCHES[name]
    got = run(amap)
    const, scalar = run(torch.full_like(amap, 0.75)), run(torch.tensor(0.75, device=cuda_device))
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 3
    err = (got - ref).abs().max().item()
    assert err <= gate * max(1.0, ref.abs().max().item()), err
    assert torch.equal(const, scalar)
    assert not torch.equal(got, scalar)
    with pytest.raises(ValueError, match="map"):
        run(amap[:-2])


@pytest.mark.parametrize("variant", ["lr-lrblur map", "lrblur", "stage1", "stage1 map"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pipeline_eval_variants_card_matches_cpu(cuda_device, variant, dtype):
    """The EVAL switches served on the card at a narrow x8 tree (BASE_SIZE
    32, the x8 maps' size; GF_DIM 8) against the same pipeline on the CPU:
    float32 at the pipeline gate, bfloat16 >= 40 dB against the CPU's
    float32; one forward's launches (stage 1: one attention, one up-head
    site); the replay at B = 4 bit for bit the eager forward."""
    ev = {"lr-lrblur map": dict(INPUT_NETGH="lr-lrblur", WEIGHTMAP=True),
          "lrblur": dict(INPUT_NETGH="lrblur"), "stage1": dict(STAGE1=True),
          "stage1 map": dict(STAGE1=True, INPUT_NETGH="lr-lrblur", WEIGHTMAP=True)}[variant]
    cfg = Config(TREE=TreeConfig(4, 32), GAN=GanConfig(8, 10, 2), TEXT=TextConfig(32, 6),
                 EVAL=EvalConfig(**ev))
    sds = init_seeded(cfg, 41, torch.Generator().manual_seed(0))
    kern = SRPipeline(cfg, 41, *sds, device=cuda_device, compute_dtype=dtype)
    plain = SRPipeline(cfg, 41, *sds, device="cpu")
    rng = np.random.default_rng(0)
    lr = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    cap = rng.integers(1, 41, (4, 6))
    cap[1, :] = 0
    cap[2, 3:] = 0
    lens = np.array([6, 0, 3, 6])
    ref = plain(lr, cap, lens)
    _build.reset_launches()
    got = kern(lr, cap, lens)
    torch.cuda.synchronize()
    n_att = 1 if variant.startswith("stage1") else 3
    site = "up_head" if dtype == torch.float32 else "up_head_packed"
    assert _build.LAUNCHES == dict(ZERO, word_pixel_attention=n_att, **{site: min(n_att, 2)})
    if dtype == torch.float32:
        for p, pr in zip(got["pyramid"], ref["pyramid"]):
            torch.testing.assert_close(p.cpu(), pr, rtol=1e-3, atol=2e-4)
    else:
        d = got["sr"].cpu().double() - ref["sr"].double()
        assert 10 * np.log10(4.0 / d.square().mean().item()) >= 40
    eager = to_uint8(got["sr"])
    assert np.array_equal(kern.sr_uint8(lr, cap, lens), eager.cpu().numpy())


# -- the GRU text encoder and the library modules (no kernel of their own) -----

@pytest.mark.parametrize("path", ["float32", "bfloat16", "int8"])
def test_gru_graph_replay_equals_eager(cuda_device, path):
    """A GRU text encoder (RNN_TYPE 'GRU'): the forward replayed at B = 3
    (graph batch 4) launches the LSTM path's kernels and equals the uint8 of
    the eager __call__ bit for bit."""
    cfg = Config(RNN_TYPE="GRU", TREE=TreeConfig(4, 8),
                 GAN=GanConfig(32 if path == "int8" else 8, 10, 2), TEXT=TextConfig(32, 6))
    sds = init_seeded(cfg, 41, torch.Generator().manual_seed(1))
    kw = {} if path == "float32" else dict(compute_dtype=torch.bfloat16)
    if path == "int8":
        lr, cap, lens = _serving_batch(4, seed=9)
        kw["quant_scales"] = SRPipeline(cfg, 41, *sds, device=cuda_device, **kw
                                        ).calibrate_quant(lr / 127.5 - 1.0, cap, lens)
    pipe = SRPipeline(cfg, 41, *sds, device=cuda_device, **kw)
    assert pipe.text_encoder.rnn_type == pipe.cfg.RNN_TYPE == "GRU"
    lr, cap, lens = _serving_batch(3, seed=2)
    pipe.forward_scan(lr[None], cap[None], lens[None])  # captures
    _build.reset_launches()
    got = pipe.forward_scan(lr[None], cap[None], lens[None])[0]
    torch.cuda.synchronize()
    assert _build.LAUNCHES == ZERO
    assert _build.REPLAYED == dict(ZERO, **PATH_LAUNCHES[path])
    sel = np.arange(4) % 3
    lrf = torch.as_tensor(lr, device=cuda_device).float() / 127.5 - 1.0
    assert torch.equal(got, to_uint8(pipe(lrf[sel], cap[sel], lens[sel])["sr"])[:3])


def test_weighted_attention_on_the_card_matches_the_cpu(cuda_device):
    """WordPixelAttentionWeighted (plain torch on every device) on the card
    against the CPU, TF32 off: rtol = atol = 1e-5, attention maps too."""
    from tgsr_tpu_torch.ops.attention import WordPixelAttentionWeighted

    gen = torch.Generator().manual_seed(3)
    m = WordPixelAttentionWeighted(32, 256)
    torch.nn.init.normal_(m.conv_context.weight, std=0.05, generator=gen)
    px = torch.randn(4, 32, 64, 64, generator=gen)
    words = torch.randn(4, 18, 256, generator=gen)
    mask = torch.arange(18)[None, :] >= torch.tensor([18, 3, 0, 9])[:, None]
    with torch.no_grad():
        ref = m(px, words, mask, need_attn=True)
        got = m.to(cuda_device)(px.to(cuda_device), words.to(cuda_device),
                                mask.to(cuda_device), need_attn=True)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.cpu(), r, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["InitStageGImg", "NextStageGLR", "EDCoder", "InitStageGim"])
def test_variants_on_the_card_match_the_cpu(cuda_device, name):
    """Library stages of models/variants.py at GF_DIM 32 on the card against
    the CPU in eval mode (TF32 off, max abs error <= 1e-3); the two that
    attend launch row 1's kernel once."""
    from tgsr_tpu_torch.checkpoints.from_jax import _seed_module
    from tgsr_tpu_torch.models import variants

    gen = torch.Generator().manual_seed(4)
    u = lambda *s: torch.rand(s, generator=gen) * 2 - 1
    words = u(2, 18, 256)
    mask = torch.arange(18)[None, :] >= torch.tensor([18, 4])[:, None]
    m, args, attends = {
        "InitStageGImg": (variants.InitStageGImg(32, 2, cdf=256), (u(2, 3, 32, 32), words, mask),
                          1),
        "NextStageGLR": (variants.NextStageGLR(32, 2, 256), (u(2, 32, 64, 64), words, mask), 1),
        "EDCoder": (variants.EDCoder(32), (u(2, 3, 64, 64),), 0),
        "InitStageGim": (variants.InitStageGim(32, 8, 100), (u(2, 3, 32, 32), u(2, 100)), 0),
    }[name]
    _seed_module(m, gen)
    m.eval().requires_grad_(False)
    with torch.no_grad():
        ref = m(*args)
        _build.reset_launches()
        got = m.to(cuda_device)(*(a.to(cuda_device) for a in args))
        torch.cuda.synchronize()
    assert _build.LAUNCHES["word_pixel_attention"] == attends
    ref, got = (x if isinstance(x, tuple) else (x,) for x in (ref, got))
    for g, r in zip(got, ref):
        assert (g.cpu() - r).abs().max().item() <= 1e-3


def test_decoder_reads_every_fixture_as_pil_on_the_card_machine(cuda_device):
    """The committed JPEG and PNG fixtures (tests/torch_fixtures/), decoded on
    the card machine's host by data/codec.py (the JPEG decoder built there
    by its C compiler), bit for bit PIL's arrays committed beside them."""
    import os

    from tgsr_tpu_torch.data import codec

    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures")
    with np.load(os.path.join(d, "pil_rgb.npz")) as z:
        assert len(z.files) >= 28
        for name in z.files:
            np.testing.assert_array_equal(codec.load_image_rgb(os.path.join(d, name)), z[name],
                                          err_msg=name)


def test_profile_trace_names_the_launched_kernels(cuda_device, tmp_path):
    """`profile_trace` around the attention kernel: the trace's kernel events
    name it."""
    import json

    from tgsr_tpu_torch.utils.observability import profile_trace

    rng = np.random.default_rng(0)
    px = torch.from_numpy(rng.normal(size=(2, 32, 32, 32)).astype(np.float32)).to(cuda_device)
    wd = torch.from_numpy(rng.normal(size=(2, 18, 32)).astype(np.float32)).to(cuda_device)
    mask = torch.zeros(2, 18, dtype=torch.bool, device=cuda_device)
    word_pixel_attention(px, wd, mask)  # built and loaded before the trace
    torch.cuda.synchronize()
    with profile_trace(str(tmp_path)) as path:
        word_pixel_attention(px, wd, mask)
        torch.cuda.synchronize()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    assert any("word_pixel_attention_kernel" in k for k in kernels), sorted(kernels)[:20]


@pytest.mark.parametrize("cfg", [
    # (B, H, W, Cin, Cout, BN, output step): the face S8 UpBlock sites at
    # B = 2, a ragged pixel count (35, not a multiple of the block's 64), no
    # BN, the widest Cin / Cout the kernel takes, and the narrowest
    (2, 32, 32, 64, 64, True, None), (2, 64, 64, 32, 64, True, None),
    (2, 128, 128, 64, 64, True, 3.0), (1, 5, 7, 32, 64, True, 3.0),
    (1, 8, 8, 32, 64, False, None), (1, 9, 6, 128, 128, True, None), (3, 4, 4, 32, 16, True, 1.0),
])
def test_int8_upconv_phases_matches_plain(cuda_device, cfg):
    """X3 (csrc/int8_upconv.cu, one launch for the four phases) against the
    plain version (four float64 phase convs on the int8 values, then the
    float32 epilogue), bfloat16 and float32 outputs."""
    b, h, w, cin, cout, bn, out_scale = cfg
    g = torch.Generator(device=cuda_device).manual_seed(h * cin + cout)
    x = torch.randint(-127, 128, (b, h, w, cin), generator=g, device=cuda_device,
                      dtype=torch.int8)
    wt = pack_phase_weight(torch.randint(-127, 128, (2, 2, cin, 4 * cout), generator=g,
                                         device=cuda_device, dtype=torch.int8))
    scale = torch.rand(4 * cout, generator=g, device=cuda_device) * 1e-5 + 1e-6
    affine = ((1 + 0.1 * torch.randn(cout, generator=g, device=cuda_device),
               0.1 * torch.randn(cout, generator=g, device=cuda_device)) if bn else None)
    step = act_step(out_scale) if out_scale else None
    pre = int8_upconv_plain(x, wt, scale, affine, None, torch.float32)
    for dtype in (torch.bfloat16, torch.float32):
        before = _build.LAUNCHES["int8_upconv_phases"]
        got = int8_upconv_phases(x, wt, scale, affine, out_scale, dtype)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["int8_upconv_phases"] == before + 1
        ref = int8_upconv_plain(x, wt, scale, affine, out_scale, dtype)
        assert got.shape == ref.shape == (b, 2 * h, 2 * w, cout // 2) and got.dtype == dtype
        assert matches_plain(got, ref, step, pre)[0]


def test_int8_upconv_phases_refusals(cuda_device):
    """Shapes the kernel does not take raise before any launch."""
    before = dict(_build.LAUNCHES)
    for cin, cout in ((16, 64), (32, 24), (160, 64)):
        x = torch.zeros(1, 4, 4, cin, dtype=torch.int8, device=cuda_device)
        wt = pack_phase_weight(torch.zeros(2, 2, cin, 4 * cout, dtype=torch.int8,
                                           device=cuda_device))
        with pytest.raises(ValueError, match="int8_upconv_phases"):
            int8_upconv_phases(x, wt, torch.ones(4 * cout, device=cuda_device))
    assert _build.LAUNCHES == before


def test_pipeline_fused_up_int8_card_matches_cpu(cuda_device):
    """The int8 forward with every UpBlock site by phases (`fused_up`) on the
    card against the same pipeline and scales on the CPU, >= 40 dB; per
    forward 6 X3 launches, 36 int8 convs, 6 + 8 GLU-requant passes, 28
    requantized conv inputs (the two head-feeding sites' heads requantize
    their input), 3 attention launches."""
    from tgsr_tpu_torch.engine.quant import FUSED_UP_OUT_CONSUMER

    cfg = Config(TREE=TreeConfig(4, 8), GAN=GanConfig(32, 10, 2), TEXT=TextConfig(32, 6))
    sds = init_seeded(cfg, 41, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    lr = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    cap = rng.integers(1, 41, (2, 6))
    cap[1, 3:] = 0
    lens = np.array([6, 3])
    scales = SRPipeline(cfg, 41, *sds, device=cuda_device, compute_dtype=torch.bfloat16
                        ).calibrate_quant(lr, cap, lens)
    sites = frozenset({"h_net1/upsample/conv", "h_net2/upsample/conv", "upscale2x/conv",
                       "upscale4x/conv", *FUSED_UP_OUT_CONSUMER}) - {"upscale16x/conv"}
    kw = dict(compute_dtype=torch.bfloat16, quant_scales=scales, fused_up=sites)
    ref = SRPipeline(cfg, 41, *sds, device="cpu", **kw)(lr, cap, lens)
    kern = SRPipeline(cfg, 41, *sds, device=cuda_device, **kw)
    _build.reset_launches()
    got = kern(lr, cap, lens)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == dict(ZERO, word_pixel_attention=3, int8_conv=36,
                                   int8_upconv_phases=6, glu_requant_one=6,
                                   glu_requant_pair=8, requant=28)
    d = to_uint8(got["sr"].cpu()).double() - to_uint8(ref["sr"]).double()
    assert 10 * np.log10(255 ** 2 / max(d.square().mean().item(), 1e-12)) >= 40
