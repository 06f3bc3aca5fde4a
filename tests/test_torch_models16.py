"""The x16 family's generators (tgsr_tpu_torch/models/models16.py) against
tgsr_tpu.models.models16 on the CPU, f32, at a small x16 geometry (BASE_SIZE
8 -> 16/32/64/128 px, GF_DIM 8, T 6), on one seeded tgsr_tpu init carried
across with `state_dicts_from_jax`.

Gates: rtol = atol = 1e-4 on every image, attention map, mu and logvar (the
block gate of the port; four stages of float32 convs summed in another
order). The tying is structural: the port's h_net2 / h_net3 / h_net4 and
img_net1..4 are one module each, in the float32 module, its bfloat16 cast
and its int8 copy. JAX's half-pixel nearest resize at a factor of 2 and
`F.interpolate(mode="nearest")` pick the same source pixel: equal bit for
bit (the 512 px blend of NetGHighWeight16 rests on it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tgsr_tpu.engine import quant as jquant
from tgsr_tpu.models.models16 import GSRNetLow16 as JGSRNetLow16
from tgsr_tpu.models.models16 import NetGHighWeight16 as JNetGHighWeight16
from tgsr_tpu_torch.checkpoints.from_jax import conv_sites, init_seeded, state_dicts_from_jax
from tgsr_tpu_torch.engine.precision import cast_floats
from tgsr_tpu_torch.engine.quant import SPLIT_RES_GLU_SITES, effective_split_glu
from tgsr_tpu_torch.models.generator import GSRNetLow
from tgsr_tpu_torch.models.models16 import (GSRNetLow16, NetGHighWeight16, make_generators,
                                            unused_blocks)
from tgsr_tpu_torch.models.quantized import QuantResBlock, QuantUpBlock, quantize_generator
from tests.torch_parity import VOCAB, configs, inputs, jax_trees16

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
T = 6
LENS = [T, 3]


@pytest.fixture(scope="module", params=[False, True], ids=["jax-init", "with-unused"])
def setup(request):
    jcfg, tcfg = configs(base_size=8, branch_num=5)
    trees = jax_trees16(jcfg, unused=request.param)
    return dict(jcfg=jcfg, tcfg=tcfg, trees=trees, sds=state_dicts_from_jax(*trees),
                unused=request.param)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _generators(setup):
    netg, netgh = make_generators(setup["tcfg"], unused_blocks(setup["sds"][2]))
    netg.load_state_dict(setup["sds"][1], strict=True)
    netgh.load_state_dict(setup["sds"][2], strict=True)
    netgh.a.fill_(setup["sds"][3])
    return netg.eval(), netgh.eval()


def test_low16_matches_jax(setup):
    jcfg = setup["jcfg"]
    rng = np.random.default_rng(1)
    lr, _, _ = inputs(2, 8, T, LENS)
    E = jcfg.TEXT.EMBEDDING_DIM
    words = rng.normal(size=(2, T, E)).astype(np.float32)
    sent = rng.normal(size=(2, E)).astype(np.float32)
    mask = np.arange(T)[None, :] >= np.asarray(LENS)[:, None]
    fake_r, att_r, mu_r, logvar_r = JGSRNetLow16(
        ngf=jcfg.GAN.GF_DIM, c_dim=jcfg.GAN.CONDITION_DIM).apply(
        setup["trees"][1], lr, sent, words, mask)
    netg, _ = _generators(setup)
    assert isinstance(netg, GSRNetLow16)
    with torch.no_grad():
        fake, att, mu, logvar = netg(_nchw(lr), torch.from_numpy(sent), torch.from_numpy(words),
                                     torch.from_numpy(mask), need_attn=True)
    assert len(fake) == len(fake_r) == 4 and len(att) == 4
    for i, (f, fr) in enumerate(zip(fake, fake_r)):
        assert f.shape[-1] == 16 * 2 ** i
        np.testing.assert_allclose(_nhwc(f), np.asarray(fr), **TOL, err_msg=f"stage {i}")
    for i, (a, ar) in enumerate(zip(att, att_r)):
        np.testing.assert_allclose(a.numpy(), np.asarray(ar), **TOL, err_msg=f"attn {i}")
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_r), **TOL)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(logvar_r), **TOL)


def test_high16_matches_jax(setup):
    jcfg = setup["jcfg"]
    rng = np.random.default_rng(2)
    lr, _, _ = inputs(2, 8, T, LENS)
    srb = [rng.uniform(-1, 1, (2, z, z, 3)).astype(np.float32) for z in jcfg.pyramid_sizes()]
    ims_r, _, _ = JNetGHighWeight16(ngf=jcfg.GAN.GF_DIM, low="lr",
                                    sizes=tuple(jcfg.pyramid_sizes())).apply(
        setup["trees"][2], lr, srb, lr)
    _, netgh = _generators(setup)
    assert isinstance(netgh, NetGHighWeight16)
    assert hasattr(netgh, "upscale16x") == hasattr(netgh, "residual816") == setup["unused"]
    with torch.no_grad():
        ims = netgh(_nchw(lr), [_nchw(s) for s in srb])
    assert [i.shape[-1] for i in ims] == jcfg.pyramid_sizes()
    for i, (f, fr) in enumerate(zip(ims, ims_r)):
        np.testing.assert_allclose(_nhwc(f), np.asarray(fr), **TOL, err_msg=f"scale {i}")


@pytest.mark.parametrize("h, w", [(2, 3), (8, 8), (64, 40), (5, 7)])
def test_nearest_x2_is_jax_resize(h, w):
    x = np.random.default_rng(h * w).normal(size=(2, h, w, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 2 * h, 2 * w, 3), "nearest"))
    got = _nhwc(F.interpolate(_nchw(x), scale_factor=2, mode="nearest"))
    np.testing.assert_array_equal(got, want)


def test_tied_modules_are_one(setup):
    """One module under every alias name: in the float32 module, after a
    bfloat16 cast and in the int8 copy; the state dict carries each alias
    key set with the shared tensors; a parameter count without repeats."""
    netg, _ = _generators(setup)
    assert netg.h_net2 is netg.h_net3 is netg.h_net4
    assert netg.img_net1 is netg.img_net2 is netg.img_net3 is netg.img_net4
    assert netg.img_net1.use_tanh and isinstance(netg.img_net1.img[1], torch.nn.Tanh)
    sd = netg.state_dict()
    for k in [k for k in sd if k.startswith("h_net2.")]:
        for alias in ("h_net3", "h_net4"):
            assert torch.equal(sd[alias + k[6:]], sd[k])
    x8 = GSRNetLow(8, 32, 10, 2, 2)  # the same two stages untied, plus an x8 head
    assert (sum(p.numel() for p in netg.parameters())
            == sum(p.numel() for p in x8.parameters()) - 8 * 9 * 3)
    keys = conv_sites(netg, _generators(setup)[1])["netg"]
    fake_scales = {k: 2.0 for k in keys}
    cast = cast_floats(_generators(setup)[0], torch.bfloat16)
    assert cast.h_net2 is cast.h_net4 and cast.img_net1 is cast.img_net3
    q = quantize_generator(cast, keys, fake_scales, effective_split_glu(fake_scales),
                           SPLIT_RES_GLU_SITES)
    assert q.h_net2 is q.h_net3 is q.h_net4 and q.img_net1 is q.img_net4
    assert isinstance(q.h_net4.residual[0], QuantResBlock)
    assert isinstance(q.h_net3.upsample, QuantUpBlock) and q.h_net3.upsample.out_scale is None
    n_int8 = {id(m) for m in q.modules() if isinstance(m, (QuantResBlock, QuantUpBlock))}
    assert len(n_int8) == 2 * 2 + 2  # two ResBlocks and an UpBlock a stage, h_net1 and h_net2


def test_conv_sites_are_the_jax_tree_kernels(setup):
    """The port's site table names exactly the conv kernels of the JAX x16
    trees (conv_kernel_sites), residual816 / upscale16x included exactly
    when the weights carry them, so that fingerprints and scale keys
    agree."""
    netg, netgh = _generators(setup)
    sites = conv_sites(netg, netgh)
    for group, tree in (("netg", setup["trees"][1]), ("netgh", setup["trees"][2])):
        assert sorted(sites[group]) == sorted(jquant.conv_kernel_sites(tree["params"]))
    assert ("upscale16x/conv" in sites["netgh"]) == setup["unused"]


def test_init_seeded_x16_loads_strict():
    _, tcfg = configs(base_size=8, branch_num=5)
    text, netg_sd, netgh_sd, a = init_seeded(tcfg, VOCAB, torch.Generator().manual_seed(0))
    assert a == 0.5 and unused_blocks(netgh_sd) == ()
    assert torch.equal(netg_sd["h_net2.upsample.1.weight"], netg_sd["h_net4.upsample.1.weight"])
    netg, netgh = make_generators(tcfg)
    netg.load_state_dict(netg_sd, strict=True)
    netgh.load_state_dict(netgh_sd, strict=True)
