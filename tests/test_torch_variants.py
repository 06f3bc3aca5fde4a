"""The library blocks and generator variants of tgsr_tpu_torch against
tgsr_tpu on the CPU, f32: `DownBlock`, `Block3x3Relu`, `PlainResidualBlock`
(ops/blocks.py), `WordPixelAttentionWeighted` and `word_region_attention`
(ops/attention.py), and every module of models/variants.py.

Each JAX module is initialised from a seed (BN statistics and affine moved
off (0, 1)), carried across by `from_jax.library_state_dict` (strict), and
both run on the same numpy inputs (NHWC for JAX, NCHW for the port): in
eval mode the outputs, in train mode the outputs and the BN running
statistics after the step (flax's rule: biased variance, momentum 0.9),
read back with `library_variables`. Gate rtol = atol = 1e-4 (ROADMAP's
block gate). The tree also round-trips: `library_variables` of the loaded
module gives JAX's tree back bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from tgsr_tpu.models import variants as jv
from tgsr_tpu.ops import attention as jatt
from tgsr_tpu.ops import blocks as jblocks
from tgsr_tpu_torch.checkpoints.from_jax import library_state_dict, library_variables
from tgsr_tpu_torch.models import variants as tv
from tgsr_tpu_torch.ops import attention as tatt
from tgsr_tpu_torch.ops import blocks as tblocks
from tests.torch_parity import _perturb
from tests.torch_train_parity import flat

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
B, T, CDF = 3, 6, 12


def _rng(seed):
    return np.random.default_rng(seed)


def _img(seed, h, c, w=None):
    return _rng(seed).normal(size=(B, h, w or h, c)).astype(np.float32)


def _words(seed, e=CDF):
    return _rng(seed).normal(size=(B, T, e)).astype(np.float32)


MASK = np.arange(T)[None, :] >= np.array([T, 3, 1])[:, None]


def case(jm, jargs, pm, how, outs=("img",), train=True, **port_kw):
    """One comparison: JAX module and its NHWC args, the port module, how
    each arg crosses ("img": NHWC -> NCHW, "-": as it is), what each output
    is ("img": NCHW -> NHWC; "-": attention maps [B, T, H, W] and vectors,
    as they are), whether the module takes `train`, the port's kwargs."""
    return dict(jm=jm, jargs=jargs, pm=pm, how=how, outs=outs, train=train, kw=port_kw)


W, S = _words, lambda seed, e: _words(seed, e)[:, 0]
CASES = {
    "DownBlock": lambda: case(jblocks.DownBlock(8), (_img(0, 8, 4),), tblocks.DownBlock(4, 8),
                              ("img",)),
    "Block3x3Relu": lambda: case(jblocks.Block3x3Relu(8), (_img(0, 8, 4),),
                                 tblocks.Block3x3Relu(4, 8), ("img",)),
    "PlainResidualBlock": lambda: case(jblocks.PlainResidualBlock(8), (_img(0, 8, 8),),
                                       tblocks.PlainResidualBlock(8), ("img",)),
    "PlainResidualBlock norm": lambda: case(
        jblocks.PlainResidualBlock(8, use_norm=True), (_img(0, 8, 8),),
        tblocks.PlainResidualBlock(8, use_norm=True), ("img",)),
    "WordPixelAttentionWeighted": lambda: case(
        jatt.WordPixelAttentionWeighted(8), (_img(1, 4, 8), W(2), MASK),
        tatt.WordPixelAttentionWeighted(8, CDF), ("img", "-", "-"), ("img", "-"), False,
        need_attn=True),
    "InitStageG": lambda: case(jv.InitStageG(32), (S(3, 20), S(4, 10)), tv.InitStageG(32, 30),
                               ("-", "-")),
    "InitStageGup4": lambda: case(jv.InitStageGup4(16), (S(3, 20), S(4, 10)),
                                  tv.InitStageGup4(16, 30), ("-", "-")),
    "InitStageGim": lambda: case(jv.InitStageGim(8, 8), (_img(5, 32, 3), S(6, 10)),
                                 tv.InitStageGim(8, 8, c_dim=10), ("img", "-")),
    "InitStageGim scale 4": lambda: case(jv.InitStageGim(8, 4), (_img(5, 16, 3), S(6, 10)),
                                         tv.InitStageGim(8, 4, c_dim=10), ("img", "-")),
    "InitStageGf": lambda: case(jv.InitStageGf(16, 8), (_img(7, 32, 5), S(6, 10)),
                                tv.InitStageGf(16, 8, c_dim=10, feat_ch=5), ("img", "-")),
    "InitStageGfc": lambda: case(jv.InitStageGfc(16, 8), (S(6, 10),),
                                 tv.InitStageGfc(16, 8, c_dim=10), ("-",)),
    "InitStageGfc scale 1": lambda: case(jv.InitStageGfc(16, 1), (S(6, 10),),
                                         tv.InitStageGfc(16, 1, c_dim=10), ("-",)),
    "InitStageGImg": lambda: case(jv.InitStageGImg(8, 2), (_img(8, 8, 3), W(9), MASK),
                                  tv.InitStageGImg(8, 2, cdf=CDF), ("img", "-", "-")),
    "InitStageGImg weightatten": lambda: case(
        jv.InitStageGImg(8, 2, weightatten=True), (_img(8, 8, 3), W(9), MASK),
        tv.InitStageGImg(8, 2, weightatten=True, cdf=CDF), ("img", "-", "-")),
    "NextStageGNoAttn": lambda: case(jv.NextStageGNoAttn(8, 2), (_img(10, 8, 6),),
                                     tv.NextStageGNoAttn(8, 2, in_ch=6), ("img",)),
    "NextStageGLR": lambda: case(jv.NextStageGLR(8, 1), (_img(11, 8, 8), W(12), MASK),
                                 tv.NextStageGLR(8, 1, cdf=CDF), ("img", "-", "-"),
                                 ("img", "-")),
    "EDCoder": lambda: case(jv.EDCoder(4), (_img(13, 16, 3),), tv.EDCoder(4), ("img",)),
    "IAWD": lambda: case(jv.IAWD(16), (_img(14, 4, 6), W(15, 16)), tv.IAWD(16, in_ch=6),
                         ("img", "-"), ("-",), False),
    "WordAtten": lambda: case(jv.WordAtten(16), (_img(14, 4, 6), W(15, 16)),
                              tv.WordAtten(16, in_ch=6), ("img", "-"), ("-",), False),
    "IAWDSent": lambda: case(jv.IAWDSent(), (_img(16, 8, 6), S(17, 16)), tv.IAWDSent(in_ch=6),
                             ("img", "-"), ("-",), False),
    "IAWDWord": lambda: case(jv.IAWDWord(), (_img(16, 8, 6), _rng(18).normal(
        size=(B, 16, 5)).astype(np.float32)), tv.IAWDWord(in_ch=6), ("img", "-"), ("-",), False),
    "IAWDSpatial": lambda: case(jv.IAWDSpatial(), (_img(19, 4, 6), W(20, 16)), tv.IAWDSpatial(),
                                ("img", "-"), ("-",), False),
}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _setup(name):
    c = CASES[name]()
    variables = c["jm"].init(jax.random.PRNGKey(0), *map(jnp.asarray, c["jargs"]),
                             **({"train": False} if c["train"] else {}))
    c["variables"] = _perturb(unfreeze(jax.tree.map(np.asarray, variables)), _rng(1))
    if c["variables"]:
        c["pm"].load_state_dict(library_state_dict(c["pm"], c["variables"]), strict=True)
    return c


def _run_port(c, train):
    args = [_nchw(a) if h == "img" else torch.from_numpy(np.asarray(a))
            for a, h in zip(c["jargs"], c["how"])]
    with torch.no_grad():
        out = c["pm"].train(train)(*args, **c["kw"])
    out = out if isinstance(out, tuple) else (out,)
    return [o.permute(0, 2, 3, 1).numpy() if kind == "img" else o.numpy()
            for o, kind in zip(out, c["outs"])]


def _compare(got, ref, name):
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref), name
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g, np.asarray(r), err_msg=f"{name} output {i}", **TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_eval_matches_jax(name):
    c = _setup(name)
    ref = c["jm"].apply(c["variables"], *map(jnp.asarray, c["jargs"]),
                        **({"train": False} if c["train"] else {}))
    _compare(_run_port(c, False), ref, name)
    back, want = flat(library_variables(c["pm"])), flat(c["variables"])
    assert back.keys() == want.keys()
    for k, v in want.items():
        assert np.array_equal(back[k], v), k


TRAINED = sorted(n for n in CASES if CASES[n]()["train"] and n != "PlainResidualBlock")


@pytest.mark.parametrize("name", TRAINED)
def test_train_mode_matches_jax(name):
    """Train-mode BN: the outputs on the batch's moments and the running
    statistics JAX's mutable batch_stats hold after the call."""
    c = _setup(name)
    ref, upd = c["jm"].apply(c["variables"], *map(jnp.asarray, c["jargs"]), train=True,
                             mutable=["batch_stats"])
    _compare(_run_port(c, True), ref, name)
    stats = flat(library_variables(c["pm"])["batch_stats"])
    ref_stats = flat(jax.tree.map(np.asarray, unfreeze(upd["batch_stats"])))
    assert stats.keys() == ref_stats.keys()
    for k, v in ref_stats.items():
        np.testing.assert_allclose(stats[k], v, err_msg=f"{name} {k}", **TOL)


def test_word_region_attention_is_func_attention():
    regions = _rng(21).normal(size=(B, 9, CDF)).astype(np.float32)
    words = _words(22)
    ref = jatt.word_region_attention(jnp.asarray(words), jnp.asarray(regions), 4.0,
                                     word_mask=jnp.asarray(MASK))
    got = tatt.word_region_attention(torch.from_numpy(words), torch.from_numpy(regions), 4.0,
                                     word_mask=torch.from_numpy(MASK))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_fc_entry_grid_is_channel_major():
    """`_FcEntry`'s 4 x 4 grid is torch's view(-1, ngf, 4, 4): feature
    c * 16 + y * 4 + x of the GLU output lands at channel c, pixel (y, x)."""
    m = tv._FcEntry(2, 3).eval()
    with torch.no_grad():
        feats = torch.nn.functional.glu(m.fc_bn(m.fc(torch.ones(1, 3))), dim=-1)
        grid = m(torch.ones(1, 3))
    assert torch.equal(grid[0, 1, 2, 3], feats[0, 1 * 16 + 2 * 4 + 3])
