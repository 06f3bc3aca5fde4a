"""int8 serving of tgsr_tpu_torch against tgsr_tpu's int8 mode on the CPU.

One seeded tgsr_tpu init (BN statistics perturbed, blend a = 0.3) is
carried across with `state_dicts_from_jax`; scales come from tgsr_tpu's own
`calibrate_quant` in bfloat16, and both packages serve with them
(compute_dtype bfloat16). Where they round differently: JAX's bf16 logistic
on the CPU rounds exp, 1 + and 1 / each to bfloat16 and XLA keeps some bf16
products in float32, while the port rounds the gate once and each product
once; so an int8 GLU output may move by a step (tests/test_torch_glu_requant.py
pins that down). Gates, therefore, by PSNR of uint8 images and by error
relative to the output range:

- single quantized blocks under `quant_interceptor` with the same split
  sets (ResBlock, residual sequence, UpBlock split or not, an int8 head fed
  by its UpBlock's requantized GLU): max abs error <= 2^-5 * max |ref| + 2^-6
  (a few int8 steps of the block's inputs through one conv);
- the pipeline: uint8 PSNR >= 40 dB against JAX int8, with heads quantized
  and with `drop_head_scales`; the port's int8-versus-its-own-float32 PSNR at
  most 1 dB below JAX's int8-versus-JAX-float32; row 0 of a mixed-length
  batch within 1 uint8 level of its B = 1 result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax.core import unfreeze

from tgsr_tpu.engine import quant as jq
from tgsr_tpu.engine.inference import SRPipeline as JSRPipeline
from tgsr_tpu.engine.inference import _cast_floats as jax_cast
from tgsr_tpu.models.generator_hf import _ConvOutput, _ResidualSeq
from tgsr_tpu.ops.blocks import ResBlock as JResBlock
from tgsr_tpu.ops.blocks import UpBlock as JUpBlock
from tgsr_tpu_torch.checkpoints import from_jax
from tgsr_tpu_torch.engine import quant as tq
from tgsr_tpu_torch.engine.inference import SRPipeline, to_uint8
from tgsr_tpu_torch.engine.precision import cast_floats
from tgsr_tpu_torch.models.generator_hf import _residual_seq
from tgsr_tpu_torch.models.quantized import (QuantConv, QuantResBlock, QuantUpBlock,
                                             quantize_generator)
from tgsr_tpu_torch.ops.blocks import ResBlock, UpBlock
from tests.torch_parity import SMALL, VOCAB, _perturb, configs, inputs, jax_trees

torch.set_num_threads(1)
T = SMALL["WORDS_NUM"]


# -- single blocks ----------------------------------------------------------

class _JBlocks(fnn.Module):
    kind: str

    @fnn.compact
    def __call__(self, x):
        if self.kind == "res":
            return JResBlock(16, name="residual_0")(x)
        if self.kind == "seq":
            return _ResidualSeq(8, name="residual24")(x)
        if self.kind == "up":
            return JUpBlock(8, name="upscale2x")(x)
        return _ConvOutput(True, name="conv_output")(JUpBlock(8, name="upscale8x")(x))


class _TBlocks(torch.nn.Module):
    # as NetGHighWeight: upscale8x's output feeds only its head
    head_only_upblocks = frozenset({"upscale8x/conv"})

    def __init__(self, kind: str, cin: int):
        super().__init__()
        self.kind = kind
        if kind == "res":
            self.residual_0 = ResBlock(16)
        elif kind == "seq":
            self.residual24 = _residual_seq(8)
        else:
            setattr(self, "upscale2x" if kind == "up" else "upscale8x", UpBlock(cin, 8))
            if kind == "head":
                self.conv_output = torch.nn.Sequential(
                    torch.nn.Conv2d(8, 3, 5, padding=2, bias=False), torch.nn.Tanh())

    def forward(self, x):
        if self.kind == "res":
            return self.residual_0(x)
        if self.kind == "seq":
            return self.residual24(x)
        if self.kind == "up":
            return self.upscale2x(x)
        return self.conv_output(self.upscale8x(x))


def _sites(kind):
    if kind == "res":
        return from_jax._resblock_sites("residual_0", "residual_0.block")
    if kind == "seq":
        return from_jax._resblock_sites("residual24", "residual24")
    if kind == "up":
        return {"upscale2x/conv": "upscale2x.1"}
    return {"upscale8x/conv": "upscale8x.1", "conv_output/conv": "conv_output.0"}


def _state_dict(kind, variables):
    p, s = variables["params"], variables["batch_stats"]
    out = {}
    from_jax._put_convs(out, p, _sites(kind))
    if kind == "res":
        from_jax._put_resblock_bn(out, "residual_0.block", p["residual_0"], s["residual_0"])
    elif kind == "seq":
        from_jax._put_resblock_bn(out, "residual24", p["residual24"], s["residual24"])
    else:
        name = "upscale2x" if kind == "up" else "upscale8x"
        from_jax._put_bn(out, f"{name}.2", p[name]["bn"], s[name]["bn"])
    return out


@pytest.mark.parametrize("kind,split", [("res", True), ("seq", True), ("up", True),
                                        ("up", False), ("head", True)])
def test_block_matches_quant_interceptor(kind, split):
    cin = 16 if kind == "res" else 8
    rng = np.random.default_rng(len(kind))
    x = rng.normal(0, 1, (2, 6, 6, cin)).astype(np.float32)
    mod = _JBlocks(kind)
    variables = _perturb(unfreeze(jax.tree.map(
        np.asarray, mod.init(jax.random.PRNGKey(3), jnp.asarray(x)))), rng)
    vb = jax_cast(variables, jnp.bfloat16)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    scales = jq.calibrate(lambda v: mod.apply(vb, v), xb, margin=1.1)
    assert set(scales) == set(_sites(kind))
    split_glu = jq.effective_split_glu(scales) if split else frozenset()
    with fnn.intercept_methods(jq.quant_interceptor(scales, split_glu=split_glu,
                                                    split_res=jq.SPLIT_RES_GLU_SITES)):
        ref = np.asarray(mod.apply(vb, xb).astype(jnp.float32))

    port = _TBlocks(kind, cin)
    port.load_state_dict(_state_dict(kind, variables), strict=True)
    cast_floats(port.eval(), torch.bfloat16)
    q = quantize_generator(port, _sites(kind), scales, split_glu, tq.SPLIT_RES_GLU_SITES)
    swapped = {"res": QuantResBlock, "seq": QuantResBlock, "up": QuantUpBlock,
               "head": QuantUpBlock}[kind]
    assert any(isinstance(m, swapped) for m in q.modules())
    if kind == "head":
        assert isinstance(q.conv_output[0], QuantConv)
        assert q.upscale8x.out_scale == scales["conv_output/conv"]  # int8 into the head
    with torch.no_grad():
        got = q(torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16())
    got = got.permute(0, 2, 3, 1).float().numpy()
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= 2 ** -5 * np.abs(ref).max() + 2 ** -6, (err, np.abs(ref).max())


# -- the pipeline -----------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs()
    trees = jax_trees(jcfg)
    sds = from_jax.state_dicts_from_jax(*trees)
    lr, cap, lens = inputs(4, jcfg.TREE.BASE_SIZE, T, [T, 3, 0, 5], seed=11)
    scales = JSRPipeline(jcfg, VOCAB, *trees, compute_dtype=jnp.bfloat16).calibrate_quant(
        lr, cap, lens)
    return dict(jcfg=jcfg, tcfg=tcfg, trees=trees, sds=sds, scales=scales,
                jax_f32=JSRPipeline(jcfg, VOCAB, *trees),
                port_f32=SRPipeline(tcfg, VOCAB, *sds, device="cpu"))


def _pipes(setup, scales):
    return (JSRPipeline(setup["jcfg"], VOCAB, *setup["trees"], compute_dtype=jnp.bfloat16,
                        quant_scales=scales),
            SRPipeline(setup["tcfg"], VOCAB, *setup["sds"], device="cpu",
                       compute_dtype=torch.bfloat16, quant_scales=scales))


def _psnr_u8(a, b):
    a = to_uint8(torch.as_tensor(np.array(a))).double()
    b = to_uint8(torch.as_tensor(np.array(b))).double()
    return 10 * np.log10(255 ** 2 / max(((a - b) ** 2).mean().item(), 1e-12))


@pytest.mark.parametrize("heads", [True, False])
def test_call_matches_jax_int8(setup, heads):
    scales = setup["scales"] if heads else jq.drop_head_scales(setup["scales"])
    jpipe, tpipe = _pipes(setup, scales)
    lr, cap, lens = inputs(3, setup["jcfg"].TREE.BASE_SIZE, T, [T, 2, 0], seed=12)
    ref, got = jpipe(lr, cap, lens), tpipe(lr, cap, lens)
    assert tuple(got["sr"].shape) == (3, 64, 64, 3) and got["sr"].dtype == torch.float32
    for p, pr in zip(got["pyramid"], ref["pyramid"]):
        assert _psnr_u8(p.numpy(), pr) >= 40
    jax_vs_f32 = _psnr_u8(ref["sr"], setup["jax_f32"](lr, cap, lens)["sr"])
    port_vs_f32 = _psnr_u8(got["sr"].numpy(), setup["port_f32"](lr, cap, lens)["sr"].numpy())
    assert port_vs_f32 >= jax_vs_f32 - 1.0, (port_vs_f32, jax_vs_f32)


def test_modules_swapped_where_scales_are(setup):
    """Heads quantized: every conv of both generators is int8 (ResBlocks and
    residual sequences as whole blocks); the plain generators stay bf16 and
    unquantized; the up-head sites are off."""
    _, tpipe = _pipes(setup, setup["scales"])
    kinds = {}
    for module in (tpipe.serve_netg, tpipe.serve_netgh):
        for m in module.modules():
            kinds[type(m).__name__] = kinds.get(type(m).__name__, 0) + 1
    # netg: 6 ResBlocks, 3 UpBlocks, im2f + 3 heads; netgh: 6 + 2, 3, convin + conv_output
    assert kinds["QuantResBlock"] == 14 and kinds["QuantUpBlock"] == 6
    assert kinds["QuantConv"] == 6
    assert tpipe.netg_up_head is None and tpipe.netgh_up_head is None
    assert not any(isinstance(m, (QuantConv, QuantResBlock, QuantUpBlock))
                   for m in tpipe.netg.modules())
    assert tpipe.serve_netg.h_net3.upsample.out_scale == setup["scales"]["netg"]["img_net3/conv"]
    assert tpipe.serve_netg.h_net1.upsample.out_scale is None


def test_row_equals_single(setup):
    _, tpipe = _pipes(setup, setup["scales"])
    lr, cap, lens = inputs(2, setup["jcfg"].TREE.BASE_SIZE, T, [2, T], seed=4)
    sr2 = to_uint8(tpipe(lr, cap, lens)["sr"]).int()
    sr1 = to_uint8(tpipe(lr[:1], cap[:1], lens[:1])["sr"]).int()
    assert (sr2[:1] - sr1).abs().max().item() <= 1


def test_entry_points_run(setup):
    """sr_batched (N = 5 at microbatch 2, uint8 ingress), forward_scan and
    __call__ give the same uint8 rows; sr_batched is within 40 dB of JAX's."""
    jpipe, tpipe = _pipes(setup, setup["scales"])
    lr, cap, lens = inputs(5, setup["jcfg"].TREE.BASE_SIZE, T, [T, 3, 0, 1, 5], seed=5)
    lr8 = np.round((lr + 1) * 127.5).astype(np.uint8)
    got = tpipe.sr_batched(lr8, cap, lens, microbatch=2)
    assert got.shape == (5, 64, 64, 3) and got.dtype == np.uint8
    ref = jpipe.sr_batched(lr8, cap, lens, microbatch=2)
    mse = np.mean((got.astype(np.float64) - ref.astype(np.float64)) ** 2)
    assert 10 * np.log10(255 ** 2 / mse) >= 40
    scan = tpipe.forward_scan(lr8[:4].reshape(2, 2, *lr8.shape[1:]),
                              cap[:4].reshape(2, 2, T), lens[:4].reshape(2, 2))
    np.testing.assert_array_equal(scan.reshape(4, 64, 64, 3).numpy(), got[:4])
    direct = to_uint8(tpipe(lr8[:2].astype(np.float32) / 127.5 - 1.0, cap[:2],
                            lens[:2])["sr"]).numpy()
    np.testing.assert_array_equal(direct, got[:2])


def test_float32_with_scales_is_not_ported(setup):
    """float32 compute with scales, which the port refused until it served
    it (JAX's `cli.test --no-bf16 --int8`), now builds the int8 modules in
    float32, with the up-head sites off, and serves float32 SR."""
    tpipe = SRPipeline(setup["tcfg"], VOCAB, *setup["sds"], device="cpu",
                       quant_scales=setup["scales"])
    assert tpipe.compute_dtype == torch.float32
    assert tpipe.netg_up_head is None and tpipe.netgh_up_head is None
    quantized = [m for m in tpipe.serve_netg.modules() if isinstance(m, QuantResBlock)]
    assert quantized and all(m.bn1_mul.dtype == torch.float32 for m in quantized)
    lr, cap, lens = inputs(2, setup["jcfg"].TREE.BASE_SIZE, T, [T, 2], seed=6)
    sr = tpipe(lr, cap, lens)["sr"]
    assert sr.dtype == torch.float32 and bool(torch.isfinite(sr).all())


# -- int8 with float32 compute ----------------------------------------------

@pytest.mark.parametrize("kind,split", [("res", True), ("seq", True), ("up", True),
                                        ("up", False), ("head", True)])
def test_block_matches_quant_interceptor_f32(kind, split):
    """The quantized blocks in float32 compute against `quant_interceptor`
    with out_dtype float32 on the float32 variables: int8 conv outputs and
    the residual GLU in float32, then requantized (JAX's
    `_res_block_split`, its UpBlock branch and `quant_conv`). Both sides
    compute the same float32 values up to the sigmoid's last bit, so the
    gate is the bf16 one's a quarter."""
    cin = 16 if kind == "res" else 8
    rng = np.random.default_rng(10 + len(kind))
    x = rng.normal(0, 1, (2, 6, 6, cin)).astype(np.float32)
    mod = _JBlocks(kind)
    variables = _perturb(unfreeze(jax.tree.map(
        np.asarray, mod.init(jax.random.PRNGKey(4), jnp.asarray(x)))), rng)
    scales = jq.calibrate(lambda v: mod.apply(variables, v), jnp.asarray(x), margin=1.1)
    split_glu = jq.effective_split_glu(scales) if split else frozenset()
    with fnn.intercept_methods(jq.quant_interceptor(scales, out_dtype=jnp.float32,
                                                    split_glu=split_glu,
                                                    split_res=jq.SPLIT_RES_GLU_SITES)):
        ref = np.asarray(mod.apply(variables, jnp.asarray(x)))
    port = _TBlocks(kind, cin)
    port.load_state_dict(_state_dict(kind, variables), strict=True)
    q = quantize_generator(port.eval(), _sites(kind), scales, split_glu,
                           tq.SPLIT_RES_GLU_SITES)
    with torch.no_grad():
        got = q(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32
    got = got.permute(0, 2, 3, 1).numpy()
    err = np.abs(got - ref).max()
    assert err <= 2 ** -7 * np.abs(ref).max() + 2 ** -8, (err, np.abs(ref).max())


@pytest.fixture(scope="module")
def scales_f32(setup):
    """Scales JAX's float32 pipeline records (cli.test --int8 calibrates on
    a float32 twin)."""
    lr, cap, lens = inputs(4, setup["jcfg"].TREE.BASE_SIZE, T, [T, 3, 0, 5], seed=11)
    return setup["jax_f32"].calibrate_quant(lr, cap, lens)


@pytest.mark.parametrize("heads", [True, False])
def test_call_matches_jax_int8_f32(setup, scales_f32, heads):
    """int8 with float32 compute: the port against JAX's int8 float32
    pipeline on the same scales, >= 40 dB (uint8) at every pyramid level,
    and the port's int8-versus-float32 PSNR at most 1 dB below JAX's."""
    scales = scales_f32 if heads else jq.drop_head_scales(scales_f32)
    jpipe = JSRPipeline(setup["jcfg"], VOCAB, *setup["trees"], compute_dtype=jnp.float32,
                        quant_scales=scales)
    tpipe = SRPipeline(setup["tcfg"], VOCAB, *setup["sds"], device="cpu",
                       compute_dtype=torch.float32, quant_scales=scales)
    lr, cap, lens = inputs(3, setup["jcfg"].TREE.BASE_SIZE, T, [T, 2, 0], seed=13)
    ref, got = jpipe(lr, cap, lens), tpipe(lr, cap, lens)
    assert tuple(got["sr"].shape) == (3, 64, 64, 3) and got["sr"].dtype == torch.float32
    for p, pr in zip(got["pyramid"], ref["pyramid"]):
        assert _psnr_u8(p.numpy(), pr) >= 40
    jax_vs_f32 = _psnr_u8(ref["sr"], setup["jax_f32"](lr, cap, lens)["sr"])
    port_vs_f32 = _psnr_u8(got["sr"].numpy(), setup["port_f32"](lr, cap, lens)["sr"].numpy())
    assert port_vs_f32 >= jax_vs_f32 - 1.0, (port_vs_f32, jax_vs_f32)
