"""The float fused upsample of tgsr_tpu_torch against tgsr_tpu's: the 2x2
phase kernel made from the 3x3 one (`fuse_upconv_weight`, JAX's
`fuse_upconv_kernel_jnp`, bit for bit in float32 and bfloat16), the fused
conv (`upconv2x_fused`), `UpBlock(fused=True)` against the unfused block, and
`SRPipeline(fused_upsample=True)` against JAX's at the small geometry (float32
at float reassociation, rtol = atol = 2e-5; bfloat16 >= 50 dB, the bf16 tests'
gate) and against the port's unfused pipeline. Under int8 a fused UpBlock
stays in the compute dtype, as JAX's interceptor leaves it (>= 40 dB against
JAX's). x16 ignores the switch, as JAX's SRPipeline does."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tgsr_tpu.engine.inference import SRPipeline as JSRPipeline
from tgsr_tpu.ops import fused_upsample as jfu
from tgsr_tpu_torch.checkpoints.from_jax import init_seeded, state_dicts_from_jax
from tgsr_tpu_torch.engine.inference import SRPipeline
from tgsr_tpu_torch.ops.blocks import UpBlock
from tgsr_tpu_torch.ops.fused_upsample import fuse_upconv_weight, upconv2x_fused
from tests.torch_parity import SMALL, VOCAB, configs, inputs, jax_trees

torch.set_num_threads(1)
T = SMALL["WORDS_NUM"]


def psnr_u8(a, b) -> float:
    u8 = lambda x: np.round(np.clip((np.asarray(x, np.float64) + 1) * 127.5, 0, 255))  # noqa: E731
    mse = ((u8(a) - u8(b)) ** 2).mean()
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs()
    trees = jax_trees(jcfg)
    lr, cap, lens = inputs(3, jcfg.TREE.BASE_SIZE, T, [T, 2, 0], seed=11)
    return dict(jcfg=jcfg, tcfg=tcfg, trees=trees, sds=state_dicts_from_jax(*trees),
                inputs=(lr, cap, lens))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fuse_upconv_weight_matches_jax_bit_for_bit(dtype):
    w = np.random.default_rng(0).normal(size=(3, 3, 8, 12)).astype(np.float32)
    ref = np.asarray(jfu.fuse_upconv_kernel_jnp(jnp.asarray(w).astype(dtype)).astype(jnp.float32))
    got = fuse_upconv_weight(torch.from_numpy(w).to(getattr(torch, dtype))).float().numpy()
    assert got.shape == (2, 2, 8, 48)
    np.testing.assert_array_equal(got, ref)


def test_upconv2x_fused_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 7, 8)).astype(np.float32)  # odd sizes: every border case
    wf = jfu.fuse_upconv_kernel(rng.normal(size=(3, 3, 8, 6)).astype(np.float32))
    ref = np.asarray(jfu.upconv2x_fused(jnp.asarray(x), jnp.asarray(wf)))
    got = upconv2x_fused(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(wf))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-6, atol=1e-6)


def test_fused_upblock_equals_unfused_and_keeps_its_keys():
    torch.manual_seed(0)
    up = UpBlock(8, 6).eval()
    with torch.no_grad():
        up.bn.running_mean.normal_()
        up.bn.running_var.uniform_(0.5, 2.0)
    fused = UpBlock(8, 6, fused=True).eval()
    fused.load_state_dict(up.state_dict(), strict=True)  # the parameter stays the 3x3 kernel
    x = torch.randn(2, 8, 5, 7)
    with torch.no_grad():
        ref, got = up(x), fused(x)
    assert got.shape == ref.shape == (2, 6, 10, 14)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pipeline_fused_upsample_matches_jax(setup, dtype):
    lr, cap, lens = setup["inputs"]
    jpipe = JSRPipeline(setup["jcfg"], VOCAB, *setup["trees"], fused_upsample=True,
                        compute_dtype=getattr(jnp, dtype))
    port = SRPipeline(setup["tcfg"], VOCAB, *setup["sds"], device="cpu", fused_upsample=True,
                      compute_dtype=getattr(torch, dtype))
    plain = SRPipeline(setup["tcfg"], VOCAB, *setup["sds"], device="cpu",
                       compute_dtype=getattr(torch, dtype))
    assert all(m.fused for m in port.netg.modules() if isinstance(m, UpBlock))
    assert sum(isinstance(m, UpBlock) and m.fused for m in port.netgh.modules()) == 3
    ref = jpipe(lr, cap, lens)
    got = port(lr, cap, lens)
    unfused = plain(lr, cap, lens)
    for g, r, u in zip(got["pyramid"], ref["pyramid"], unfused["pyramid"]):
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-5, atol=2e-5)
            np.testing.assert_allclose(g.numpy(), u.numpy(), rtol=2e-5, atol=2e-5)
        else:
            assert psnr_u8(g.numpy(), np.asarray(r)) >= 50
            assert psnr_u8(g.numpy(), u.numpy()) >= 50


def test_int8_leaves_fused_upblocks_in_the_compute_dtype(setup):
    lr, cap, lens = setup["inputs"]
    scales = SRPipeline(setup["tcfg"], VOCAB, *setup["sds"], device="cpu",
                        compute_dtype=torch.bfloat16).calibrate_quant(lr, cap, lens)
    port = SRPipeline(setup["tcfg"], VOCAB, *setup["sds"], device="cpu", fused_upsample=True,
                      compute_dtype=torch.bfloat16, quant_scales=scales)
    ups = [m for g in (port.serve_netg, port.serve_netgh) for m in g.modules()
           if isinstance(m, UpBlock)]
    assert len(ups) == 6 and all(m.fused for m in ups)
    jpipe = JSRPipeline(setup["jcfg"], VOCAB, *setup["trees"], fused_upsample=True,
                        compute_dtype=jnp.bfloat16, quant_scales=scales)
    assert psnr_u8(port(lr, cap, lens)["sr"].numpy(), np.asarray(jpipe(lr, cap, lens)["sr"])) >= 40


def test_x16_ignores_fused_upsample():
    _, tcfg = configs(branch_num=5)
    sds = init_seeded(tcfg, VOCAB, torch.Generator().manual_seed(0))
    pipe = SRPipeline(tcfg, VOCAB, *sds, device="cpu", fused_upsample=True)
    assert not pipe.fused_upsample
    assert not any(getattr(m, "fused", False) for g in (pipe.netg, pipe.netgh)
                   for m in g.modules())
