"""The int8 UpBlock by phases (`_fused_up_int8`, tgsr_tpu/engine/quant.py
:250-305) in tgsr_tpu_torch: `models.quantized.QuantUpBlockPhases` over the
plain version of `int8_upconv_phases` (the CPU implementation of
`tgsr::int8_upconv_phases`; its kernel, csrc/int8_upconv.cu, is held to it in
tests/test_torch_kernels_cuda.py), against JAX's function on one block
(float32 and bfloat16 compute, with and without the head's output scale),
the plain int32 sums against the unfused int8 conv on the upsample, and the
whole int8 forward with every UpBlock site by phases against JAX's
(FUSED_UP_SITES set there as here): the int8 gate, >= 40 dB. FUSED_UP_SITES
is empty by default, as JAX's, so the default int8 path runs no phase
module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgsr_tpu.engine import quant as jq
from tgsr_tpu.engine.inference import SRPipeline as JSRPipeline
from tgsr_tpu.ops.blocks import UpBlock as JUpBlock
from tgsr_tpu_torch.checkpoints.from_jax import state_dicts_from_jax
from tgsr_tpu_torch.engine import quant as tq
from tgsr_tpu_torch.engine.inference import SRPipeline
from tgsr_tpu_torch.models.quantized import QuantUpBlock, QuantUpBlockPhases
from tgsr_tpu_torch.ops.blocks import UpBlock, depth_to_space
from tgsr_tpu_torch.ops.fused_upsample import fuse_upconv_weight
from tgsr_tpu_torch.ops.int8_conv import int8_conv_int32
from tgsr_tpu_torch.ops.int8_upconv import (int8_upconv_int32, int8_upconv_phases,
                                            matches_plain, pack_phase_weight)
from tests.test_torch_fused_upsample import psnr_u8
from tests.torch_parity import SMALL, VOCAB, configs, inputs, jax_trees

torch.set_num_threads(1)
T = SMALL["WORDS_NUM"]
UP_SITES = frozenset({"h_net1/upsample/conv", "h_net2/upsample/conv", "h_net3/upsample/conv",
                      "upscale2x/conv", "upscale4x/conv", "upscale8x/conv"})


def test_fused_up_sites_empty_by_default():
    assert tq.FUSED_UP_SITES == jq.FUSED_UP_SITES == frozenset()


def _block(cin=16, c2=8, seed=0):
    rng = np.random.default_rng(seed)
    v = {"params": {"conv": {"kernel": rng.normal(0, 0.2, (3, 3, cin, 2 * c2)).astype(np.float32)},
                    "bn": {"scale": (1 + rng.normal(0, 0.1, 2 * c2)).astype(np.float32),
                           "bias": rng.normal(0, 0.1, 2 * c2).astype(np.float32)}},
         "batch_stats": {"bn": {"mean": rng.normal(0, 0.2, 2 * c2).astype(np.float32),
                                "var": rng.uniform(0.5, 2.0, 2 * c2).astype(np.float32)}}}
    up = UpBlock(cin, c2).eval()
    with torch.no_grad():
        up.conv.weight.copy_(torch.from_numpy(v["params"]["conv"]["kernel"]).permute(3, 2, 0, 1))
        up.bn.weight.copy_(torch.from_numpy(v["params"]["bn"]["scale"]))
        up.bn.bias.copy_(torch.from_numpy(v["params"]["bn"]["bias"]))
        up.bn.running_mean.copy_(torch.from_numpy(v["batch_stats"]["bn"]["mean"]))
        up.bn.running_var.copy_(torch.from_numpy(v["batch_stats"]["bn"]["var"]))
    return v, up


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("out_scale", [None, 2.5])
def test_phase_block_matches_jax_fused_up_int8(dtype, out_scale):
    v, up = _block()
    x = np.random.default_rng(1).normal(0, 1, (2, 5, 6, 16)).astype(np.float32)
    jv = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), v)
    mod = JUpBlock(8).bind(jv)
    ref = np.asarray(jq._fused_up_int8(mod, jnp.asarray(x).astype(dtype), "k", {"k": 3.0},
                                       out_scale=out_scale).astype(jnp.float32))
    got = QuantUpBlockPhases(up.to(getattr(torch, dtype)), 3.0, out_scale)(
        torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).float().numpy()
    assert got.shape == ref.shape == (2, 10, 12, 8)
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def test_phase_sums_equal_the_conv_on_the_upsample():
    """With an integer 3x3 kernel whose phase sums fit int8, the four 2x2
    phase convs' int32 sums, depth-to-spaced, are the unfused int8 conv on
    the nearest-x2 upsample (both plain versions, exact)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-127, 128, (2, 5, 7, 32), generator=g, dtype=torch.int8)
    q3 = torch.randint(-14, 15, (3, 3, 32, 16), generator=g, dtype=torch.int8)
    q2 = fuse_upconv_weight(q3.to(torch.int32)).to(torch.int8)
    phases = int8_upconv_int32(x, pack_phase_weight(q2).q)  # [4, B, H, W, C]
    packed = torch.cat(list(phases), dim=-1)
    np.testing.assert_array_equal(depth_to_space(packed, 2).numpy(),
                                  int8_conv_int32(x, q3, up2=True).numpy())


def test_phase_kernel_refuses_grad():
    _, up = _block(cin=32, c2=8)
    blk = QuantUpBlockPhases(up, 3.0)
    scale = blk.scale.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        int8_upconv_phases(torch.zeros(1, 2, 2, 32, dtype=torch.int8),
                           pack_phase_weight(blk.q), scale)


def test_phase_op_fake_shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode

    _, up = _block(cin=32, c2=8)
    blk = QuantUpBlockPhases(up, 3.0)
    with FakeTensorMode(allow_non_fake_inputs=True):
        out = torch.ops.tgsr.int8_upconv_phases(torch.zeros(3, 4, 5, 32, dtype=torch.int8),
                                                blk.q, blk.packed, blk.scale, None, None, 1.0,
                                                torch.bfloat16)
    assert tuple(out.shape) == (3, 8, 10, 8) and out.dtype == torch.bfloat16


def _ulps_up(x, n):
    for _ in range(n):
        x = torch.nextafter(x, torch.full_like(x, float("inf")))
    return x


@pytest.mark.parametrize("dtype, ulps, ok", [
    (torch.bfloat16, 0, True), (torch.bfloat16, 1, True), (torch.bfloat16, 2, False),
    (torch.float32, 4, True), (torch.float32, 5, False)])
def test_matches_plain_ulps(dtype, ulps, ok):
    """X3's gate (shared by the card tests and the card smoke): one
    element `ulps` above the plain value."""
    ref = (torch.linspace(0.1, 3.0, 64) * torch.tensor([1.0, -1.0]).repeat(32)).to(dtype)
    got = ref.clone()
    got[5] = _ulps_up(got[5:6], ulps)[0]
    assert matches_plain(got, ref)[0] is ok


@pytest.mark.parametrize("near_half, ok", [(True, True), (False, False)])
def test_matches_plain_one_step_only_near_a_half(near_half, ok):
    """With an output step, one value a step off passes only where the GLU
    output before the requantize over the step lies at a half."""
    step = 3.0 / 127
    pre = torch.full((8,), 2.5 * step if near_half else 2.2 * step)
    ref = torch.round(pre / step) * step
    got = ref.clone()
    got[3] += step
    assert matches_plain(got, ref, step, pre)[0] is ok


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs()
    trees = jax_trees(jcfg)
    sds = state_dicts_from_jax(*trees)
    lr, cap, lens = inputs(3, jcfg.TREE.BASE_SIZE, T, [T, 2, 0], seed=5)
    scales = SRPipeline(tcfg, VOCAB, *sds, device="cpu", compute_dtype=torch.bfloat16
                        ).calibrate_quant(lr, cap, lens)
    return dict(jcfg=jcfg, tcfg=tcfg, trees=trees, sds=sds, scales=scales,
                inputs=(lr, cap, lens))


def test_default_int8_path_runs_no_phase_module(setup):
    pipe = SRPipeline(setup["tcfg"], VOCAB, *setup["sds"], device="cpu",
                      compute_dtype=torch.bfloat16, quant_scales=setup["scales"])
    mods = [m for g in (pipe.serve_netg, pipe.serve_netgh) for m in g.modules()]
    assert not any(isinstance(m, QuantUpBlockPhases) for m in mods)
    assert sum(isinstance(m, QuantUpBlock) for m in mods) == 6


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_pipeline_fused_up_matches_jax(setup, dtype, monkeypatch):
    lr, cap, lens = setup["inputs"]
    monkeypatch.setattr(jq, "FUSED_UP_SITES", UP_SITES)
    jpipe = JSRPipeline(setup["jcfg"], VOCAB, *setup["trees"], compute_dtype=getattr(jnp, dtype),
                        quant_scales=setup["scales"])
    port = SRPipeline(setup["tcfg"], VOCAB, *setup["sds"], device="cpu",
                      compute_dtype=getattr(torch, dtype), quant_scales=setup["scales"],
                      fused_up=UP_SITES)
    mods = [m for g in (port.serve_netg, port.serve_netgh) for m in g.modules()]
    assert sum(isinstance(m, QuantUpBlockPhases) for m in mods) == 6
    got = port(lr, cap, lens)
    ref = jpipe(lr, cap, lens)
    for g, r in zip(got["pyramid"], ref["pyramid"]):
        assert psnr_u8(g.numpy(), np.asarray(r)) >= 40
    unfused = SRPipeline(setup["tcfg"], VOCAB, *setup["sds"], device="cpu",
                         compute_dtype=getattr(torch, dtype), quant_scales=setup["scales"])
    assert psnr_u8(got["sr"].numpy(), unfused(lr, cap, lens)["sr"].numpy()) >= 40
