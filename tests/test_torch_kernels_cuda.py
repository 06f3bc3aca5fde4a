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
"""

import numpy as np
import pytest
import torch

from tgsr_tpu_torch.checkpoints.from_jax import init_seeded
from tgsr_tpu_torch.config import Config, GanConfig, TextConfig, TreeConfig
from tgsr_tpu_torch.engine.inference import SRPipeline
from tgsr_tpu_torch.ops import _build
from tgsr_tpu_torch.ops.attention import word_pixel_attention as plain_wpa
from tgsr_tpu_torch.ops.fused_attention import word_pixel_attention
from tgsr_tpu_torch.ops.up_head import fold_bn, fused_up_head, reference_up_head

pytestmark = pytest.mark.cuda


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
    assert _build.LAUNCHES == {"word_pixel_attention": 3, "up_head": 2}
    for p, pr in zip(got["pyramid"], ref["pyramid"]):
        torch.testing.assert_close(p.cpu(), pr, rtol=1e-3, atol=2e-4)
    for at, ar in zip(got["attn"], ref["attn"]):
        torch.testing.assert_close(at.cpu(), ar, rtol=1e-5, atol=1e-5)
