"""Shared helpers of the tgsr_tpu_torch parity tests: one seeded tgsr_tpu
init carried across with `state_dicts_from_jax`, and the small geometry both
packages build."""

import jax
import jax.numpy as jnp
import numpy as np
from flax.core import unfreeze

from tgsr_tpu import config as jcfg_mod
from tgsr_tpu_torch import config as tcfg_mod

VOCAB = 41
# small geometry: 8x8 LR -> 64 px, ngf 8, T 6 (the x8 tree at narrow width)
SMALL = dict(BASE_SIZE=8, GF_DIM=8, CONDITION_DIM=10, R_NUM=2,
             EMBEDDING_DIM=32, WORDS_NUM=6)


def configs(base_size=SMALL["BASE_SIZE"], gf_dim=SMALL["GF_DIM"],
            condition_dim=SMALL["CONDITION_DIM"], r_num=SMALL["R_NUM"],
            embedding_dim=SMALL["EMBEDDING_DIM"], words_num=SMALL["WORDS_NUM"],
            branch_num=4):
    """(tgsr_tpu Config, tgsr_tpu_torch Config) of one geometry, x8
    (branch_num 4) or x16 (5)."""
    out = []
    for mod in (jcfg_mod, tcfg_mod):
        out.append(mod.Config(
            RNN_TYPE="LSTM",
            TREE=mod.TreeConfig(BRANCH_NUM=branch_num, BASE_SIZE=base_size),
            GAN=mod.GanConfig(GF_DIM=gf_dim, CONDITION_DIM=condition_dim,
                              R_NUM=r_num),
            TEXT=mod.TextConfig(EMBEDDING_DIM=embedding_dim,
                                WORDS_NUM=words_num)))
    return tuple(out)


def _perturb(tree, rng):
    """Move BN statistics away from (0, 1) and BN affine away from (1, 0),
    so that eval BN and its fold do real work."""
    if not isinstance(tree, dict):
        return tree
    if set(tree) == {"mean", "var"}:
        return {"mean": rng.normal(0, 0.2, np.shape(tree["mean"])).astype(np.float32),
                "var": rng.uniform(0.5, 2.0, np.shape(tree["var"])).astype(np.float32)}
    if set(tree) == {"scale", "bias"}:
        return {"scale": (1 + rng.normal(0, 0.1, np.shape(tree["scale"]))).astype(np.float32),
                "bias": rng.normal(0, 0.1, np.shape(tree["bias"])).astype(np.float32)}
    return {k: _perturb(v, rng) for k, v in tree.items()}


def jax_trees(jcfg, vocab=VOCAB, seed=0, a=0.3):
    """Seeded tgsr_tpu trees (text, netg, netgh) as nested dicts of numpy
    arrays, BN perturbed, and the blend `a` set to `a` (not the 0.5 init, so
    that a lost `a` shows)."""
    from tgsr_tpu.models.generator import GSRNetLow
    from tgsr_tpu.models.generator_hf import NetGHighWeight
    from tgsr_tpu.models.text_encoder import TextEncoder

    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    T, E = jcfg.TEXT.WORDS_NUM, jcfg.TEXT.EMBEDDING_DIM
    s = jcfg.TREE.BASE_SIZE
    lr = jnp.zeros((1, s, s, 3))
    text = TextEncoder(vocab_size=vocab, nhidden=E, rnn_type="LSTM").init(
        keys[0], jnp.zeros((1, T), jnp.int32), jnp.ones((1,), jnp.int32))
    netg = GSRNetLow(ngf=jcfg.GAN.GF_DIM, c_dim=jcfg.GAN.CONDITION_DIM,
                     n_stages=jcfg.n_stages, r_num=jcfg.GAN.R_NUM).init(
        keys[1], lr, jnp.zeros((1, E)), jnp.zeros((1, T, E)),
        jnp.zeros((1, T), bool))
    sizes = tuple(jcfg.pyramid_sizes())
    netgh = NetGHighWeight(ngf=jcfg.GAN.GF_DIM, sizes=sizes).init(
        keys[2], lr, [jnp.zeros((1, z, z, 3)) for z in sizes], lr)
    rng = np.random.default_rng(seed)
    trees = []
    for v in (text, netg, netgh):
        trees.append(_perturb(unfreeze(jax.tree.map(np.asarray, v)), rng))
    trees[2]["params"]["a"] = np.full((1,), a, np.float32)
    return tuple(trees)


def jax_trees16(jcfg, vocab=VOCAB, seed=0, a=0.3, unused=False):
    """As `jax_trees`, for the x16 family (GSRNetLow16, NetGHighWeight16
    fix_bugs=False, low 'lr'). A JAX init never runs residual816 and
    upscale16x, so its tree lacks them; `unused` adds them (perturbed, from
    a fix_bugs=True init), as a reference .pth converted with keep_unused
    carries them."""
    from tgsr_tpu.models.models16 import GSRNetLow16, NetGHighWeight16
    from tgsr_tpu.models.text_encoder import TextEncoder

    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    T, E = jcfg.TEXT.WORDS_NUM, jcfg.TEXT.EMBEDDING_DIM
    s = jcfg.TREE.BASE_SIZE
    lr = jnp.zeros((1, s, s, 3))
    text = TextEncoder(vocab_size=vocab, nhidden=E, rnn_type="LSTM").init(
        keys[0], jnp.zeros((1, T), jnp.int32), jnp.ones((1,), jnp.int32))
    netg = GSRNetLow16(ngf=jcfg.GAN.GF_DIM, c_dim=jcfg.GAN.CONDITION_DIM,
                       r_num=jcfg.GAN.R_NUM).init(
        keys[1], lr, jnp.zeros((1, E)), jnp.zeros((1, T, E)), jnp.zeros((1, T), bool))
    sizes = tuple(jcfg.pyramid_sizes())
    netgh = NetGHighWeight16(ngf=jcfg.GAN.GF_DIM, low="lr", sizes=sizes,
                             fix_bugs=unused).init(
        keys[2], lr, [jnp.zeros((1, z, z, 3)) for z in sizes], lr)
    rng = np.random.default_rng(seed)
    trees = []
    for v in (text, netg, netgh):
        trees.append(_perturb(unfreeze(jax.tree.map(np.asarray, v)), rng))
    trees[2]["params"]["a"] = np.full((1,), a, np.float32)
    return tuple(trees)


def inputs(b, base_size, words_num, lens, seed=0, vocab=VOCAB):
    """LR in [-1, 1] [B, h, w, 3] f32, captions [B, T] (0 past len), lens."""
    rng = np.random.default_rng(seed)
    lr = rng.uniform(-1, 1, (b, base_size, base_size, 3)).astype(np.float32)
    cap = rng.integers(1, vocab, (b, words_num)).astype(np.int32)
    lens = np.asarray(lens, np.int32)
    for i, n in enumerate(lens):
        cap[i, n:] = 0
    return lr, cap, lens
