"""The x16 family served by tgsr_tpu_torch's SRPipeline against tgsr_tpu's
x16 SRPipeline on the CPU, at a small S16 geometry (BASE_SIZE 8 -> 128 px,
GF_DIM 8, T 6), on one seeded tgsr_tpu init (BN perturbed, a = 0.3)
carried across with `state_dicts_from_jax`.

Gates, those of the x8 pipeline tests: float32 by float reassociation only
(pyramid rtol 1e-3, atol 2e-4; attention rtol 1e-3, atol 1e-5; uint8 within
1 level); bfloat16 >= 50 dB (uint8 PSNR) against JAX bfloat16; int8 >= 40
dB against JAX int8 on the same scales (bfloat16 and float32 compute), the
port's int8-versus-float32 PSNR at most 1 dB below JAX's; calibration
scales within rtol 1e-4 of JAX's (float32), the tied stage's the max over
its three calls. Reference .pth files in the models16 layout load strict;
bundles go both ways. The shipped x16 scales (a byte-identical copy) bind to
the JAX package's seed-0 init of the full S16 geometry by fingerprint.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgsr_tpu.checkpoints import convert_torch, export_torch
from tgsr_tpu.config import Config as JConfig
from tgsr_tpu.config import config_from_dict as jconfig_from_dict
from tgsr_tpu.engine import quant as jq
from tgsr_tpu.engine.inference import SRPipeline as JSRPipeline
from tgsr_tpu_torch.checkpoints.from_jax import state_dicts_from_jax
from tgsr_tpu_torch.engine import quant as tq
from tgsr_tpu_torch.engine.inference import SRPipeline, to_uint8
from tgsr_tpu_torch.engine.serving import BatchingServer
from tests.torch_parity import VOCAB, configs, inputs, jax_trees16

torch.set_num_threads(1)
PYR = dict(rtol=1e-3, atol=2e-4)
ATT = dict(rtol=1e-3, atol=1e-5)
T, SIZE, OUT = 6, 8, 128
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the weights fingerprint in tgsr_tpu/checkpoints/x16_int8_scales.json's _meta
X16_FINGERPRINT = "014d759833c16736"


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs(base_size=SIZE, branch_num=5)
    trees = jax_trees16(jcfg)
    lr, cap, lens = inputs(3, SIZE, T, [T, 3, 0], seed=21)
    jbf16 = JSRPipeline(jcfg, VOCAB, *trees, compute_dtype=jnp.bfloat16)
    return dict(jcfg=jcfg, tcfg=tcfg, trees=trees, sds=state_dicts_from_jax(*trees),
                inputs=(lr, cap, lens), scales=jbf16.calibrate_quant(lr, cap, lens),
                jax_f32=JSRPipeline(jcfg, VOCAB, *trees), jax_bf16=jbf16)


def _port(setup, **kw):
    return SRPipeline(setup["tcfg"], VOCAB, *setup["sds"], device="cpu", **kw)


def _psnr_u8(a, b):
    d = to_uint8(torch.as_tensor(np.array(a))).double() - to_uint8(
        torch.as_tensor(np.array(b))).double()
    return 10 * np.log10(255 ** 2 / max(d.square().mean().item(), 1e-12))


def test_call_matches_jax_f32(setup):
    lr, cap, lens = setup["inputs"]
    jpipe = JSRPipeline(setup["jcfg"], VOCAB, *setup["trees"], return_attn=True)
    ref = jpipe(lr, cap, lens)
    got = _port(setup, return_attn=True)(lr, cap, lens)
    assert tuple(got["sr"].shape) == (3, OUT, OUT, 3)
    assert [p.shape[1] for p in got["pyramid"]] == [16, 32, 64, 128]
    for i, (p, pr) in enumerate(zip(got["pyramid"], ref["pyramid"])):
        np.testing.assert_allclose(p.numpy(), np.asarray(pr), **PYR, err_msg=f"scale {i}")
    assert len(got["attn"]) == len(ref["attn"]) == 4
    for i, (a, ar) in enumerate(zip(got["attn"], ref["attn"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(ar), **ATT, err_msg=f"attn {i}")
    du8 = (to_uint8(got["sr"]).int() - to_uint8(torch.as_tensor(np.array(ref["sr"]))).int())
    assert du8.abs().max().item() <= 1


def test_call_matches_jax_bf16(setup):
    lr, cap, lens = setup["inputs"]
    ref = setup["jax_bf16"](lr, cap, lens)
    got = _port(setup, compute_dtype=torch.bfloat16)(lr, cap, lens)
    assert got["sr"].dtype == torch.float32 and len(got["pyramid"]) == 4
    for p, pr in zip(got["pyramid"], ref["pyramid"]):
        assert _psnr_u8(p, pr) >= 50


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_call_matches_jax_int8(setup, compute):
    """Scales from JAX's calibration (bfloat16 compute), or, for float32
    compute, from JAX's float32 twin's."""
    lr, cap, lens = setup["inputs"]
    scales = (setup["scales"] if compute == "bfloat16"
              else setup["jax_f32"].calibrate_quant(lr, cap, lens))
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if compute == "bfloat16" else (jnp.float32,
                                                                              torch.float32)
    jpipe = JSRPipeline(setup["jcfg"], VOCAB, *setup["trees"], compute_dtype=jdt,
                        quant_scales=scales)
    tpipe = _port(setup, compute_dtype=tdt, quant_scales=scales)
    ref, got = jpipe(lr, cap, lens), tpipe(lr, cap, lens)
    for p, pr in zip(got["pyramid"], ref["pyramid"]):
        assert _psnr_u8(p, pr) >= 40
    jax_vs_f32 = _psnr_u8(ref["sr"], setup["jax_f32"](lr, cap, lens)["sr"])
    port_vs_f32 = _psnr_u8(got["sr"], _port(setup)(lr, cap, lens)["sr"])
    assert port_vs_f32 >= jax_vs_f32 - 1.0, (port_vs_f32, jax_vs_f32)
    # the tied stage and head are quantized once; the 512 px step of
    # upscale8x leaves its GLU in the compute dtype (its 256 px output also
    # feeds residual48)
    g, gh = tpipe.serve_netg, tpipe.serve_netgh
    assert g.h_net2 is g.h_net3 is g.h_net4 and g.img_net1 is g.img_net4
    assert gh.upscale8x.out_scale is None and gh.upscale4x.out_scale is None
    assert tpipe.netg_up_head is None and tpipe.netgh_up_head is None


def test_entry_points_match_jax(setup):
    """sr_batched (uint8 ingress, N = 5 in microbatches of 2), forward_scan,
    sr_uint8 and sr_arbitrary at a ragged LR, native and bucketed, float32,
    each within 1 uint8 level of JAX's same entry point."""
    jpipe, tpipe = setup["jax_f32"], _port(setup)
    lr, cap, lens = inputs(5, SIZE, T, [T, 3, 0, 1, 5], seed=22)
    lr8 = np.round((lr + 1) * 127.5).astype(np.uint8)
    got = tpipe.sr_batched(lr8, cap, lens, microbatch=2)
    ref = jpipe.sr_batched(lr8, cap, lens, microbatch=2)
    assert got.shape == (5, OUT, OUT, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    scan = tpipe.forward_scan(lr8[:4].reshape(2, 2, SIZE, SIZE, 3), cap[:4].reshape(2, 2, T),
                              lens[:4].reshape(2, 2))
    np.testing.assert_array_equal(scan.reshape(4, OUT, OUT, 3).numpy(), got[:4])
    one = tpipe.sr_uint8(lr[:2], cap[:2], lens[:2])
    assert np.abs(one.astype(int) - np.asarray(jpipe.sr_uint8(lr[:2], cap[:2], lens[:2]),
                                               int)).max() <= 1
    rag = np.random.default_rng(23).uniform(-1, 1, (1, 10, 14, 3)).astype(np.float32)
    for bucket in (None, 8):
        a = tpipe.sr_arbitrary(rag, cap[:1], lens[:1], bucket=bucket)
        b = np.asarray(jpipe.sr_arbitrary(rag, cap[:1], lens[:1], bucket=bucket))
        assert a.shape == b.shape == (1, 160, 224, 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_batching_server_serves_x16(setup):
    pipe = _port(setup, compute_dtype=torch.bfloat16)
    lr, cap, lens = inputs(5, SIZE, T, [T, 2, 4, 1, 3], seed=24)
    with BatchingServer(pipe, max_batch=4, max_delay_ms=10) as srv:
        outs = [f.result(timeout=300) for f in
                [srv.submit(lr[i], cap[i], lens[i]) for i in range(5)]]
    direct = pipe.sr_uint8(lr, cap, lens)
    for o, d in zip(outs, direct):
        assert o.shape == (OUT, OUT, 3) and np.abs(o.astype(int) - d.astype(int)).max() <= 1


def test_calibrate_quant_matches_jax(setup):
    """float32 calibration: JAX's keys and values (rtol 1e-4); the tied
    stage's scales are the max over its three calls (checked at one conv
    against the absmax of each call's input)."""
    lr, cap, lens = setup["inputs"]
    tpipe = _port(setup)
    calls = []
    conv = tpipe.netg.h_net2.residual[0].block[0]
    hook = conv.register_forward_pre_hook(
        lambda _m, args: calls.append(args[0].abs().amax().item()))
    got = tpipe.calibrate_quant(lr, cap, lens)
    hook.remove()
    ref = setup["jax_f32"].calibrate_quant(lr, cap, lens)
    assert {g: sorted(d) for g, d in got.items()} == {g: sorted(d) for g, d in ref.items()}
    for g in ref:
        for k, v in ref[g].items():
            assert got[g][k] == pytest.approx(v, rel=1e-4), (g, k)
    assert len(calls) == 3
    assert got["netg"]["h_net2/residual_0/conv1"] == pytest.approx(max(calls) * 1.1, rel=1e-6)


def test_reference_pth_in_models16_layout(setup, tmp_path):
    """A reference-layout x16 pair (tgsr_tpu's export_netg_low16 /
    export_netgh_weight16: the aliased h_net2/3/4 and img_net1..4 key sets,
    and residual816 / upscale16x, as a reference .pth carries them) loads
    strict=True in the port and serves JAX's from_reference_checkpoints on
    the same files; both fingerprints count the two unused blocks."""
    trees = jax_trees16(setup["jcfg"], unused=True)
    paths = [str(tmp_path / n) for n in ("text_encoder.pth", "netG_epoch_7.pth",
                                         "netGH_epoch_7.pth")]
    for path, sd in zip(paths, (export_torch.export_text_encoder(trees[0]),
                                export_torch.export_netg_low16(trees[1]),
                                export_torch.export_netgh_weight16(trees[2]))):
        export_torch.save_torch(sd, path)
    assert {"h_net4.upsample.1.weight", "img_net4.img.0.weight"} <= set(torch.load(paths[1]))
    assert "upscale16x.1.weight" in torch.load(paths[2])
    jpipe = JSRPipeline.from_reference_checkpoints(setup["jcfg"], VOCAB, paths[1],
                                                   text_encoder_path=paths[0])
    tpipe = SRPipeline.from_reference_checkpoints(setup["tcfg"], VOCAB, paths[1],
                                                  text_encoder_path=paths[0], device="cpu")
    assert hasattr(tpipe.netgh, "upscale16x") and tpipe.a == 0.5
    lr, cap, lens = setup["inputs"]
    np.testing.assert_allclose(tpipe(lr, cap, lens)["sr"].numpy(),
                               np.asarray(jpipe(lr, cap, lens)["sr"]), **PYR)
    v = jpipe.variables
    assert tpipe.weights_fingerprint() == jq.weights_fingerprint(v["netg"], v["netgh"])
    assert tpipe.weights_fingerprint() != _port(setup).weights_fingerprint()


def test_jax_x16_bundle_loads(setup, tmp_path):
    jpipe = JSRPipeline(setup["jcfg"], VOCAB, *setup["trees"], compute_dtype=jnp.bfloat16,
                        quant_scales=setup["scales"])
    jpipe.save_artifact(str(tmp_path))
    ref, _ = JSRPipeline.load_artifact(str(tmp_path))
    got, _ = SRPipeline.load_artifact(str(tmp_path), device="cpu")
    assert got.cfg.TREE.BRANCH_NUM == 5 and got.quant_scales
    lr, cap, lens = setup["inputs"]
    assert _psnr_u8(got(lr, cap, lens)["sr"], ref(lr, cap, lens)["sr"]) >= 40


def test_port_x16_bundle_round_trips_and_reads_in_jax(setup, tmp_path):
    """The port's int8 bundle loads back bit for bit, and its files serve in
    JAX: config.json through JAX's config_from_dict, the state dicts through
    JAX's x16 converters, quant_scales.json with the fingerprint the port
    stamped, which JAX's check_scales accepts on those weights (>= 40 dB
    against the port)."""
    pipe = _port(setup, compute_dtype=torch.bfloat16, quant_scales=setup["scales"])
    pipe.save_artifact(str(tmp_path))
    loaded, _ = SRPipeline.load_artifact(str(tmp_path), device="cpu")
    lr, cap, lens = setup["inputs"]
    mine = pipe(lr, cap, lens)
    for p, q in zip(mine["pyramid"], loaded(lr, cap, lens)["pyramid"]):
        assert torch.equal(p, q)
    jcfg = jconfig_from_dict(json.load(open(tmp_path / "config.json")))
    assert jcfg == setup["jcfg"]
    w = torch.load(tmp_path / "state_dicts.pt")
    np_sd = [{k: v.numpy() for k, v in w[g].items()} for g in ("text", "netg", "netgh")]
    trees = (convert_torch.convert_text_encoder(np_sd[0], "LSTM"),
             convert_torch.convert_netg_low16(np_sd[1]),
             convert_torch.convert_netgh_weight16(np_sd[2]))
    trees[2]["params"]["a"] = np.full((1,), w["a"], np.float32)
    scales = json.load(open(tmp_path / "quant_scales.json"))
    jpipe = JSRPipeline(jcfg, VOCAB, *trees, compute_dtype=jnp.bfloat16, quant_scales=scales)
    assert _psnr_u8(jpipe(lr, cap, lens)["sr"], mine["sr"]) >= 40


def test_chip_smoke_x16_cpu_numerics_and_int8_floor():
    """chip_smoke.py's x16 phase rehearsed on the CPU at full width
    (`x16_inputs`' weights and images): bfloat16 against float32 at or
    above the card's gate of 40 dB (uint8 PSNR; 58.50 dB on the CPU that
    set the floor), and X16_INT8_PSNR_FLOOR derived as x8's was, the CPU's
    int8-versus-float32 PSNR (scales from calibrate_quant on the CPU's
    bfloat16 pipeline, eight images; 44.33 dB there) less 1 dB, held to
    0.5 dB: bfloat16 calibration on another CPU's kernels moves the PSNR by
    tenths."""
    import chip_smoke

    cfg, sds, (lr, cap, lens), (lrc, capc, lensc), _ = chip_smoke.x16_inputs(torch)
    lrf = lr.astype(np.float32) / 127.5 - 1.0
    ref = SRPipeline(cfg, 41, *sds, device="cpu")(lrf, cap, lens)["sr"]
    bf16 = SRPipeline(cfg, 41, *sds, device="cpu", compute_dtype=torch.bfloat16)
    assert chip_smoke.psnr_u8(bf16(lrf, cap, lens)["sr"], ref) >= 40
    scales = bf16.calibrate_quant(lrc.astype(np.float32) / 127.5 - 1.0, capc, lensc)
    int8 = SRPipeline(cfg, 41, *sds, device="cpu", compute_dtype=torch.bfloat16,
                      quant_scales=scales)(lrf, cap, lens)["sr"]
    psnr = chip_smoke.psnr_u8(int8, ref)
    assert abs(chip_smoke.X16_INT8_PSNR_FLOOR - (psnr - 1.0)) <= 0.5, psnr


def test_shipped_x16_scales_bind_to_the_jax_seed0_init():
    """The JAX package's seed-0 init of the S16 geometry, built as
    examples/x16_bench.py:71-83 builds it, carried across: the port's
    fingerprint is the one x16_int8_scales.json records, check_scales takes
    x16_scales() there and refuses it once one conv moves; the port's copy
    of the JSON is byte-identical; the shipped face S8 scales are refused
    for the x16 family by key."""
    from tgsr_tpu.models.models16 import GSRNetLow16, NetGHighWeight16
    from tgsr_tpu.models.text_encoder import TextEncoder

    with open(os.path.join(ROOT, "tgsr_tpu", "checkpoints", "x16_int8_scales.json"), "rb") as f:
        want = f.read()
    with open(os.path.join(ROOT, "tgsr_tpu_torch", "checkpoints", "x16_int8_scales.json"),
              "rb") as f:
        assert f.read() == want
    jc = JConfig()
    jc = dataclasses.replace(jc, METHOD="S16",
                             TREE=dataclasses.replace(jc.TREE, BRANCH_NUM=5, BASE_SIZE=32),
                             GAN=dataclasses.replace(jc.GAN, GF_DIM=32))
    sizes, vocab, t = jc.pyramid_sizes(), 41, jc.TEXT.WORDS_NUM
    k = jax.random.PRNGKey(0)
    enc = TextEncoder(vocab_size=vocab, nhidden=jc.TEXT.EMBEDDING_DIM)
    caps0 = jnp.ones((2, t), jnp.int32)
    lens0 = jnp.full((2,), 6, jnp.int32)
    tv = enc.init(k, caps0, lens0)
    words, sent = enc.apply(tv, caps0, lens0)
    lr0 = jnp.zeros((2, 32, 32, 3))
    netg = GSRNetLow16(ngf=32, c_dim=jc.GAN.CONDITION_DIM)
    gv = netg.init(k, lr0, sent, words, caps0 == 0)
    fake, *_ = netg.apply(gv, lr0, sent, words, caps0 == 0)
    ghv = NetGHighWeight16(ngf=32, low="lr", sizes=tuple(sizes)).init(k, lr0, fake, lr0)
    assert jq.weights_fingerprint(gv, ghv) == X16_FINGERPRINT

    from tgsr_tpu_torch.config import config_from_file

    tcfg = config_from_file(os.path.join(ROOT, "configs", "eval_faceSR_S16.yml"))
    as_np = [jax.tree.map(np.asarray, v) for v in (tv, gv, ghv)]
    sds = state_dicts_from_jax(*as_np)
    pipe = SRPipeline(tcfg, vocab, *sds, device="cpu")
    assert pipe.weights_fingerprint() == X16_FINGERPRINT
    scales, meta = tq.split_scales_meta(tq.x16_scales())
    assert meta["weights_fingerprint"] == X16_FINGERPRINT
    tq.check_scales(scales, pipe.netg, pipe.netgh, meta=meta)
    with pytest.raises(ValueError, match="match no conv"):
        tq.check_scales(*tq.split_scales_meta(tq.face_s8_scales())[:1], pipe.netg, pipe.netgh)
    with torch.no_grad():
        pipe.netgh.upscale8x.conv.weight[0, 0, 0, 0] += 1e-3
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        tq.check_scales(scales, pipe.netg, pipe.netgh, meta=meta)
