"""The EVAL switches of tgsr_tpu_torch against tgsr_tpu on the CPU: the
blurred-LR inputs (EVAL.INPUT_NETGH 'lrblur', 'lr-lrblur'), the weight maps
(EVAL.WEIGHTMAP) and the stage-1 generator (EVAL.STAGE1).

Seeded tgsr_tpu inits (BN statistics perturbed, weight maps 1 + U(-0.5, 0.5),
a = 0.3 where there is no map) are carried across with the port's
`from_jax` functions. Gates:

- blocks, the HF branches and stage 1 as modules: rtol = atol = 1e-4;
- pipelines in float32: the pyramid at rtol 1e-3, atol 2e-4 (float
  reassociation only, as tests/test_torch_pipeline.py); bfloat16 >= 50 dB
  against JAX's bfloat16; int8 (bfloat16 compute, JAX's own scales) >= 40 dB
  of uint8 against JAX's int8.

The x8 weight maps are 64, 128 and 256 px whatever the base size (JAX's
SRPipeline passes no `sizes`), so the x8 map pipelines run at BASE_SIZE 32
with GF_DIM 8. The x16 maps follow the pyramid (BASE_SIZE 8 here).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax.core import unfreeze

import jax
from tgsr_tpu.checkpoints.convert_torch import load_generator_pair as jload_pair
from tgsr_tpu.engine.inference import SRPipeline as JSRPipeline
from tgsr_tpu.models.generator import GSRNetLow as JGSRNetLow
from tgsr_tpu.models.generator import GSRNetLowStage1 as JStage1
from tgsr_tpu.models.generator_hf import NetGHighWeight as JNetGHighWeight
from tgsr_tpu.models.models16 import GSRNetLow16 as JGSRNetLow16
from tgsr_tpu.models.models16 import NetGHighWeight16 as JNetGHighWeight16
from tgsr_tpu.models.text_encoder import TextEncoder as JTextEncoder
from tgsr_tpu.ops import blocks as jblocks
from tgsr_tpu.ops.image import gaussian_blur as jblur
from tgsr_tpu_torch.checkpoints import from_jax
from tgsr_tpu_torch.engine.inference import SRPipeline, to_uint8
from tgsr_tpu_torch.models.generator import GSRNetLowStage1
from tgsr_tpu_torch.models.generator_hf import NetGHighWeight, WeightMapSizeError, lr_blur
from tgsr_tpu_torch.models.models16 import GSRNetLow16, NetGHighWeight16, make_generators
from tgsr_tpu_torch.ops.blocks import LEAKY_SLOPE, ResBlock, UpBlockNoBN
from tests.torch_parity import VOCAB, _perturb, configs, inputs

torch.set_num_threads(1)
MOD = dict(rtol=1e-4, atol=1e-4)
PYR = dict(rtol=1e-3, atol=2e-4)
T = 6
LENS = [T, 3]


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _psnr(a, b, peak=2.0):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 10 * np.log10(peak ** 2 / mse)


def _cfgs(branch_num=4, base_size=32, low="lr", weightmap=False, stage1=False):
    jcfg, tcfg = configs(base_size=base_size, words_num=T, branch_num=branch_num)
    return tuple(dataclasses.replace(c, EVAL=dataclasses.replace(
        c.EVAL, INPUT_NETGH=low, WEIGHTMAP=weightmap, STAGE1=stage1)) for c in (jcfg, tcfg))


def _jax_trees(jcfg, seed=0):
    """Seeded tgsr_tpu trees of jcfg's pipeline (as JAX's SRPipeline builds
    its modules), BN perturbed, maps 1 + U(-0.5, 0.5), a = 0.3."""
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    e, ngf, c = jcfg.TEXT.EMBEDDING_DIM, jcfg.GAN.GF_DIM, jcfg.GAN.CONDITION_DIM
    s = jcfg.TREE.BASE_SIZE
    lr = jnp.zeros((1, s, s, 3))
    ev = jcfg.EVAL
    text = JTextEncoder(vocab_size=VOCAB, nhidden=e, rnn_type="LSTM").init(
        keys[0], jnp.zeros((1, T), jnp.int32), jnp.ones((1,), jnp.int32))
    g_args = (lr, jnp.zeros((1, e)), jnp.zeros((1, T, e)), jnp.zeros((1, T), bool))
    sizes = tuple(jcfg.pyramid_sizes())
    if jcfg.TREE.BRANCH_NUM == 5:
        netg = JGSRNetLow16(ngf=ngf, c_dim=c, r_num=2).init(keys[1], *g_args)
        gh = JNetGHighWeight16(ngf=ngf, weightmap=ev.WEIGHTMAP, low=ev.INPUT_NETGH, sizes=sizes)
    else:
        netg = (JStage1(ngf=ngf, c_dim=c, r_num=2) if ev.STAGE1 else
                JGSRNetLow(ngf=ngf, c_dim=c, n_stages=3, r_num=2)).init(keys[1], *g_args)
        gh = JNetGHighWeight(ngf=ngf, weightmap=ev.WEIGHTMAP, low=ev.INPUT_NETGH)
    srb = [jnp.zeros((1, z, z, 3)) for z in sizes]
    netgh = gh.init(keys[2], lr, srb, lr)
    rng = np.random.default_rng(seed)
    trees = [_perturb(unfreeze(jax.tree.map(np.asarray, v)), rng) for v in (text, netg, netgh)]
    params = trees[2]["params"]
    for k in [k for k in params if k in from_jax.WEIGHT_MAPS]:
        params[k] = (1 + rng.uniform(-0.5, 0.5, params[k].shape)).astype(np.float32)
    if "a" in params:
        params["a"] = np.full((1,), 0.3, np.float32)
    return tuple(trees)


# -- blocks --------------------------------------------------------------------

class _JNoBN(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        y = jblocks.ResBlock(8, use_bn=False, name="res")(x)
        return jblocks.UpBlockNoBN(4, name="up")(jblocks.leaky_relu(y))


def test_no_bn_blocks_and_leaky_relu_match_jax():
    """ResBlock(use_bn=False), LeakyReLU(0.2) and UpBlockNoBN, one after the
    other, against JAX's, with the reference's key names (block.0 / 2,
    1.weight) filled from JAX's kernels."""
    x = np.random.default_rng(0).normal(size=(2, 6, 5, 8)).astype(np.float32)
    v = unfreeze(_JNoBN().init(jax.random.PRNGKey(1), jnp.asarray(x)))["params"]
    ref = _JNoBN().apply({"params": v}, jnp.asarray(x))
    res, up = ResBlock(8, use_bn=False), UpBlockNoBN(8, 4)
    oihw = lambda k: torch.from_numpy(np.asarray(k).transpose(3, 2, 0, 1).copy())  # noqa: E731
    res.load_state_dict({"block.0.weight": oihw(v["res"]["conv1"]["kernel"]),
                         "block.2.weight": oihw(v["res"]["conv2"]["kernel"])}, strict=True)
    up.load_state_dict({"1.weight": oihw(v["up"]["conv"]["kernel"])}, strict=True)
    with torch.no_grad():
        got = up(torch.nn.LeakyReLU(LEAKY_SLOPE)(res(_nchw(x))))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **MOD)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lr_blur_matches_jax(dtype):
    """The HF branch's blur: the compute-dtype LR blurred in float32 and cast
    back, as JAX's SRPipeline._lr_blur."""
    lr, _, _ = inputs(2, 12, T, LENS, seed=1)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    lr_c = jnp.asarray(lr).astype(jdt)
    ref = np.asarray(jblur(lr_c.astype(jnp.float32), 2.0).astype(jdt).astype(jnp.float32))
    got = _nhwc(lr_blur(_nchw(lr).to(dtype)).float())
    np.testing.assert_allclose(got, ref, rtol=1e-6 if dtype == torch.float32 else 0,
                               atol=1e-6 if dtype == torch.float32 else 0)


# -- the HF branches and stage 1 as modules --------------------------------------

@pytest.mark.parametrize("low", ["lr", "lrblur", "lr-lrblur"])
@pytest.mark.parametrize("weightmap", [False, True])
def test_netgh_variants_match_jax(low, weightmap):
    """NetGHighWeight with every input and with or without a weight map (at
    the maps' own sizes, 64 / 128 / 256 px from a 32 px LR)."""
    jcfg, tcfg = _cfgs(low=low, weightmap=weightmap)
    _, _, netgh_vars = _jax_trees(jcfg, seed=2)
    rng = np.random.default_rng(2)
    lr, _, _ = inputs(2, 32, T, LENS, seed=2)
    srb = [rng.uniform(-1, 1, (2, s, s, 3)).astype(np.float32) for s in jcfg.pyramid_sizes()]
    ref, w_last, _ = JNetGHighWeight(ngf=8, weightmap=weightmap, low=low).apply(
        netgh_vars, lr, srb, jblur(jnp.asarray(lr), 2.0))
    sd, a = from_jax.netgh_state_dict(netgh_vars)
    assert (a is None) == weightmap and (("a3" in sd) == weightmap)
    m = make_generators(tcfg)[1].eval()
    m.load_state_dict(sd, strict=True)
    if a is not None:
        m.a.fill_(a)
    with torch.no_grad():
        got = m(_nchw(lr), [_nchw(s) for s in srb])
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(_nhwc(g), np.asarray(r), **MOD, err_msg=f"scale {i}")


def test_stage1_matches_jax():
    """GSRNetLowStage1: the three tanh images, mu / logvar and the nearest-
    upsampled attention maps; the shared up1 runs twice."""
    jcfg, tcfg = _cfgs(base_size=8, stage1=True)
    _, netg_vars, _ = _jax_trees(jcfg, seed=3)
    assert "batch_stats" not in netg_vars or not netg_vars["batch_stats"]
    rng = np.random.default_rng(3)
    lr, _, _ = inputs(2, 8, T, LENS, seed=3)
    e = jcfg.TEXT.EMBEDDING_DIM
    words = rng.normal(size=(2, T, e)).astype(np.float32)
    sent = rng.normal(size=(2, e)).astype(np.float32)
    mask = np.arange(T)[None, :] >= np.asarray(LENS)[:, None]
    fake_r, att_r, mu_r, logvar_r = JStage1(ngf=8, c_dim=10, r_num=2).apply(
        netg_vars, lr, sent, words, mask)
    m = make_generators(tcfg)[0].eval()
    assert isinstance(m, GSRNetLowStage1)
    m.load_state_dict(from_jax.netg_state_dict(netg_vars), strict=True)
    with torch.no_grad():
        fake, att, mu, logvar = m(_nchw(lr), torch.from_numpy(sent), torch.from_numpy(words),
                                  torch.from_numpy(mask), need_attn=True)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_r), **MOD)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(logvar_r), **MOD)
    for i, (f, fr) in enumerate(zip(fake, fake_r)):
        np.testing.assert_allclose(_nhwc(f), np.asarray(fr), **MOD, err_msg=f"stage {i}")
    for i, (a, ar) in enumerate(zip(att, att_r)):
        assert a.shape == ar.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(ar), **MOD, err_msg=f"attn {i}")


def test_netgh16_weightmap_matches_jax():
    """NetGHighWeight16 with 'lr-lrblur' and the maps a1..a4 at the pyramid's
    sizes: the 512 px blend is a4 * srb[3] (models16.py:173)."""
    jcfg, tcfg = _cfgs(branch_num=5, base_size=8, low="lr-lrblur", weightmap=True)
    _, _, netgh_vars = _jax_trees(jcfg, seed=4)
    rng = np.random.default_rng(4)
    lr, _, _ = inputs(2, 8, T, LENS, seed=4)
    sizes = tuple(jcfg.pyramid_sizes())
    srb = [rng.uniform(-1, 1, (2, s, s, 3)).astype(np.float32) for s in sizes]
    ref, _, _ = JNetGHighWeight16(ngf=8, weightmap=True, low="lr-lrblur", sizes=sizes).apply(
        netgh_vars, lr, srb, jblur(jnp.asarray(lr), 2.0))
    sd, a = from_jax.netgh_state_dict(netgh_vars)
    assert a is None and {"a1", "a2", "a3", "a4"} <= set(sd)
    m = make_generators(tcfg)[1].eval()
    assert isinstance(m, NetGHighWeight16)
    m.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = m(_nchw(lr), [_nchw(s) for s in srb])
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(_nhwc(g), np.asarray(r), **MOD, err_msg=f"scale {i}")


@pytest.mark.parametrize("kind", ["stage1", "weightmap"])
def test_trees_round_trip(kind):
    """A stage-1 netG tree (params only) and a weight-map netGH tree go to
    state dicts and back unchanged."""
    jcfg, _ = _cfgs(base_size=32 if kind == "weightmap" else 8, stage1=kind == "stage1",
                    weightmap=kind == "weightmap")
    _, netg_vars, netgh_vars = _jax_trees(jcfg, seed=5)
    if kind == "stage1":
        back = from_jax.netg_variables(from_jax.netg_state_dict(netg_vars))
        want = netg_vars
    else:
        back = from_jax.netgh_variables(*from_jax.netgh_state_dict(netgh_vars))
        want = netgh_vars
    flat = lambda t: {"/".join(map(str, k)): np.asarray(v)  # noqa: E731
                      for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    fb, fw = flat(back), flat({k: v for k, v in want.items() if v})
    assert sorted(fb) == sorted(fw)
    for k in fw:
        np.testing.assert_array_equal(fb[k], fw[k], err_msg=k)


# -- pipelines -----------------------------------------------------------------

VARIANTS = {  # (branch_num, base_size, low, weightmap, stage1)
    "x8 lr-lrblur map": (4, 32, "lr-lrblur", True, False),
    "x8 lrblur": (4, 32, "lrblur", False, False),
    "x8 stage1": (4, 8, "lr", False, True),
    "x8 stage1 lr-lrblur map": (4, 32, "lr-lrblur", True, True),
    "x16 lr-lrblur map": (5, 8, "lr-lrblur", True, False),
    "x16 stage1": (5, 8, "lr", False, True),
}


@pytest.fixture(scope="module")
def pipes():
    cache = {}

    def get(name):
        if name not in cache:
            b, s, low, wm, st1 = VARIANTS[name]
            jcfg, tcfg = _cfgs(b, s, low, wm, st1)
            trees = _jax_trees(jcfg, seed=6)
            sds = from_jax.state_dicts_from_jax(*trees)
            cache[name] = dict(jcfg=jcfg, tcfg=tcfg, trees=trees, sds=sds,
                               inputs=inputs(2, s, T, LENS, seed=7))
        return cache[name]
    return get


@pytest.mark.parametrize("name", list(VARIANTS))
def test_pipeline_f32_matches_jax(pipes, name):
    """The float32 pipeline of each variant against JAX's SRPipeline: the
    pyramid at float reassociation only. Under x16 STAGE1 both packages build
    GSRNetLow16 (JAX reads STAGE1 only for the x8 family,
    tgsr_tpu/engine/inference.py:80-108)."""
    p = pipes(name)
    jpipe = JSRPipeline(p["jcfg"], VOCAB, *p["trees"])
    tpipe = SRPipeline(p["tcfg"], VOCAB, *p["sds"], device="cpu")
    if p["tcfg"].TREE.BRANCH_NUM == 5:
        assert isinstance(tpipe.netg, GSRNetLow16) and isinstance(jpipe.netg, JGSRNetLow16)
    elif p["tcfg"].EVAL.STAGE1:
        assert isinstance(tpipe.netg, GSRNetLowStage1) and tpipe.netg_up_head is None
    ref, got = jpipe(*p["inputs"]), tpipe(*p["inputs"])
    for i, (g, r) in enumerate(zip(got["pyramid"], ref["pyramid"])):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **PYR, err_msg=f"scale {i}")


@pytest.mark.parametrize("name", ["x8 lr-lrblur map", "x8 stage1", "x16 lr-lrblur map"])
def test_pipeline_bf16_matches_jax(pipes, name):
    """bfloat16: every pyramid level >= 50 dB against JAX's bfloat16."""
    p = pipes(name)
    ref = JSRPipeline(p["jcfg"], VOCAB, *p["trees"], compute_dtype=jnp.bfloat16)(*p["inputs"])
    got = SRPipeline(p["tcfg"], VOCAB, *p["sds"], device="cpu",
                     compute_dtype=torch.bfloat16)(*p["inputs"])
    for i, (g, r) in enumerate(zip(got["pyramid"], ref["pyramid"])):
        assert _psnr(g.numpy(), np.asarray(r)) >= 50.0, f"scale {i}"


@pytest.mark.parametrize("name", ["x8 lr-lrblur map", "x8 stage1"])
def test_pipeline_int8_matches_jax(pipes, name):
    """int8 (bfloat16 compute) on JAX's own scales: the SR's uint8 >= 40 dB
    against JAX's int8. Stage 1 quantizes its no-BN convs, the tied up1 under
    one scale for both calls, the LeakyReLU after up1_conv in bfloat16."""
    p = pipes(name)
    jb = JSRPipeline(p["jcfg"], VOCAB, *p["trees"], compute_dtype=jnp.bfloat16)
    scales = jb.calibrate_quant(*p["inputs"])
    if p["tcfg"].EVAL.STAGE1:
        assert {"up1_conv", "up1_up/conv", "h_net2/conv1", "h_net3/conv2"} <= set(scales["netg"])
    jq = JSRPipeline(p["jcfg"], VOCAB, *p["trees"], compute_dtype=jnp.bfloat16,
                     quant_scales=scales)
    tq = SRPipeline(p["tcfg"], VOCAB, *p["sds"], device="cpu", compute_dtype=torch.bfloat16,
                    quant_scales=scales)
    ref = np.round(np.clip((np.asarray(jq(*p["inputs"])["sr"]) + 1) * 127.5, 0, 255))
    got = to_uint8(tq(*p["inputs"])["sr"]).numpy()
    assert _psnr(got, ref, peak=255.0) >= 40.0
    # the port's own calibration gives JAX's scale keys
    mine = SRPipeline(p["tcfg"], VOCAB, *p["sds"], device="cpu",
                      compute_dtype=torch.bfloat16).calibrate_quant(*p["inputs"])
    assert {g: sorted(d) for g, d in mine.items()} == {g: sorted(d) for g, d in scales.items()}


def test_weight_map_size_is_checked():
    """x8 weight maps are 64 / 128 / 256 px: at another base size JAX fails
    at a broadcast, the port raises WeightMapSizeError (a ValueError) naming
    the map's size; and so does sr_arbitrary at an LR the maps do not fit."""
    trees = _jax_trees(_cfgs(base_size=32, low="lr-lrblur", weightmap=True)[0], seed=8)
    jcfg, tcfg = _cfgs(base_size=8, low="lr-lrblur", weightmap=True)
    lr, cap, lens = inputs(1, 8, T, [T], seed=8)
    with pytest.raises(Exception):
        JSRPipeline(jcfg, VOCAB, *trees)(lr, cap, lens)
    pipe = SRPipeline(tcfg, VOCAB, *from_jax.state_dicts_from_jax(*trees), device="cpu")
    with pytest.raises(WeightMapSizeError, match="a1 is 64 x 64 px"):
        pipe(lr, cap, lens)
    _, tcfg32 = _cfgs(base_size=32, low="lr-lrblur", weightmap=True)
    pipe32 = SRPipeline(tcfg32, VOCAB, *from_jax.init_seeded(
        tcfg32, VOCAB, torch.Generator().manual_seed(0)), device="cpu")
    lr40, cap, lens = inputs(1, 40, T, [T], seed=9)
    with pytest.raises(ValueError, match="weight map"):
        pipe32.sr_arbitrary(lr40, cap, lens)
    lr32, cap, lens = inputs(1, 32, T, [T], seed=9)
    assert pipe32.sr_arbitrary(lr32, cap, lens).shape == (1, 256, 256, 3)


def test_stage1_reference_file(tmp_path):
    """A G_SR_NET_low_stage1 `.pth` (with the reference's dead up2) and a
    weight-map netGH `.pth` load through from_reference_checkpoints; JAX's
    load_generator_pair converts every x8 `.pth` with convert_netg_low,
    whatever STAGE1 says, and fails on the stage-1 file (a KeyError)."""
    jcfg, tcfg = _cfgs(base_size=32, low="lr-lrblur", weightmap=True, stage1=True)
    trees = _jax_trees(jcfg, seed=10)
    _, netg_sd, netgh_sd, a = from_jax.state_dicts_from_jax(*trees)
    assert a is None
    up2 = {k.replace("up1.", "up2.", 1): v.clone() for k, v in netg_sd.items()
           if k.startswith("up1.")}
    torch.save({**netg_sd, **up2}, tmp_path / "netG_epoch_7.pth")
    torch.save(netgh_sd, tmp_path / "netGH_epoch_7.pth")
    with pytest.raises(KeyError):
        jload_pair(jcfg, str(tmp_path / "netG_epoch_7.pth"))
    pipe = SRPipeline.from_reference_checkpoints(tcfg, VOCAB, str(tmp_path / "netG_epoch_7.pth"),
                                                 device="cpu")
    ref = SRPipeline(tcfg, VOCAB, pipe.state_dicts[0], netg_sd, netgh_sd, device="cpu")
    lr, cap, lens = inputs(2, 32, T, LENS, seed=11)
    assert torch.equal(pipe(lr, cap, lens)["sr"], ref(lr, cap, lens)["sr"])
    assert not any(k.startswith("up2.") for k in pipe.state_dicts[1])


def test_netgh_modules_need_their_switches():
    """A netGH built without a weight map refuses a map state dict, and the
    reverse: the maps are state-dict entries, `a` is not."""
    plain, wm = NetGHighWeight(8), NetGHighWeight(8, weightmap=True)
    assert "a" not in plain.state_dict() and {"a1", "a2", "a3"} <= set(wm.state_dict())
    assert tuple(wm.a3.shape) == (256, 256) and not hasattr(wm, "a")
    with pytest.raises(RuntimeError):
        plain.load_state_dict(wm.state_dict(), strict=True)
