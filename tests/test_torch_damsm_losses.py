"""The port's DAMSM losses (tgsr_tpu_torch/losses/damsm.py) and
`func_attention` against tgsr_tpu's on the CPU, float32, on the same numpy
inputs: B 5 captions of lengths 1, 3, 6, 2, 6 over 6 slots, 289 regions of
width 16, with and without class ids (a repeated class masks its
negatives). Gate rtol 1e-5, atol 1e-6 on values (sums of 16-wide products
and two softmaxes in another order); gradients rtol 1e-4, atol 1e-6 of max
|g| (back through both softmaxes and the log-sum-exp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgsr_tpu.losses import damsm as jd
from tgsr_tpu.ops.attention import func_attention as jfunc_attention
from tgsr_tpu_torch.losses import damsm as pd
from tgsr_tpu_torch.ops.attention import func_attention

torch.set_num_threads(1)
B, T, R, E = 5, 6, 289, 16
LENS = np.array([1, 3, 6, 2, 6], np.int32)
GAMMAS = (4.0, 5.0, 10.0)
TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return {"regions": rng.normal(size=(B, R, E)).astype(np.float32),
            "words": rng.normal(size=(B, T, E)).astype(np.float32),
            "code": rng.normal(size=(B, E)).astype(np.float32),
            "sent": rng.normal(size=(B, E)).astype(np.float32)}


def _t(x):
    return torch.from_numpy(np.asarray(x))


CLASS_IDS = {"none": None, "classes": np.array([0, 1, 0, 2, 1], np.int32)}


def test_func_attention_matches_jax():
    x = _inputs()
    mask = np.arange(T)[None, :] >= LENS[:, None]
    ctx, attn = func_attention(_t(x["words"]), _t(x["regions"]), 4.0, word_mask=_t(mask))
    jctx, jattn = jfunc_attention(jnp.asarray(x["words"]), jnp.asarray(x["regions"]), 4.0,
                                  word_mask=jnp.asarray(mask))
    assert attn.shape == (B, T, R)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), **TOL)
    np.testing.assert_allclose(attn.numpy(), np.asarray(jattn), **TOL)
    # every word's attention over the regions sums to one
    np.testing.assert_allclose(attn.sum(-1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("cls", list(CLASS_IDS))
def test_sent_loss_matches_jax(cls):
    x = _inputs(1)
    ids = CLASS_IDS[cls]
    got = pd.sent_loss(_t(x["code"]), _t(x["sent"]), None if ids is None else _t(ids), 10.0)
    ref = jd.sent_loss(jnp.asarray(x["code"]), jnp.asarray(x["sent"]),
                       None if ids is None else jnp.asarray(ids), 10.0)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(float(g), float(r), **TOL)


@pytest.mark.parametrize("cls", list(CLASS_IDS))
def test_words_loss_matches_jax(cls):
    """Ragged lengths including 1; the diagonal attention [B, T, R]."""
    x = _inputs(2)
    ids = CLASS_IDS[cls]
    w0, w1, attn = pd.words_loss(_t(x["regions"]), _t(x["words"]), _t(LENS),
                                 None if ids is None else _t(ids), *GAMMAS)
    j0, j1, jattn = jd.words_loss(jnp.asarray(x["regions"]), jnp.asarray(x["words"]),
                                  jnp.asarray(LENS), None if ids is None else jnp.asarray(ids),
                                  *GAMMAS)
    np.testing.assert_allclose(float(w0), float(j0), **TOL)
    np.testing.assert_allclose(float(w1), float(j1), **TOL)
    assert attn.shape == (B, T, R)
    np.testing.assert_allclose(attn.numpy(), np.asarray(jattn), **TOL)


def test_similarities_match_jax():
    """words_similarity [image, caption] and sent_similarity; the
    reweighted words loss (word_scale); word_confidence_scores."""
    x = _inputs(3)
    ws = pd.words_similarity(_t(x["regions"]), _t(x["words"]), _t(LENS), 4.0, 5.0)
    jws = jd.words_similarity(jnp.asarray(x["regions"]), jnp.asarray(x["words"]),
                              jnp.asarray(LENS), 4.0, 5.0)
    np.testing.assert_allclose(ws.numpy(), np.asarray(jws), **TOL)
    ss = pd.sent_similarity(_t(x["code"]), _t(x["sent"]), 10.0)
    np.testing.assert_allclose(ss.numpy(), np.asarray(jd.sent_similarity(
        jnp.asarray(x["code"]), jnp.asarray(x["sent"]), 10.0)), **TOL)
    scale = np.random.default_rng(4).uniform(0.5, 1.5, (B, T)).astype(np.float32)
    got = pd.words_loss(_t(x["regions"]), _t(x["words"]), _t(LENS), None, *GAMMAS,
                        word_scale=_t(scale))
    ref = jd.words_loss(jnp.asarray(x["regions"]), jnp.asarray(x["words"]), jnp.asarray(LENS),
                        None, *GAMMAS, word_scale=jnp.asarray(scale))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), **TOL)
    maps = np.random.default_rng(5).dirichlet(np.ones(64), (B, T)).reshape(B, T, 8, 8)
    maps = maps.astype(np.float32)
    np.testing.assert_allclose(
        pd.word_confidence_scores(_t(maps), _t(LENS)).numpy(),
        np.asarray(jd.word_confidence_scores(jnp.asarray(maps), jnp.asarray(LENS))), **TOL)


@pytest.mark.parametrize("cls", list(CLASS_IDS))
def test_gradients_match_jax(cls):
    """d(w0 + w1 + s0 + s1) / d(regions, words, code, sent)."""
    x = _inputs(6)
    ids = CLASS_IDS[cls]
    names = ("regions", "words", "code", "sent")

    def jloss(regions, words, code, sent):
        c = None if ids is None else jnp.asarray(ids)
        w0, w1, _ = jd.words_loss(regions, words, jnp.asarray(LENS), c, *GAMMAS)
        s0, s1 = jd.sent_loss(code, sent, c, GAMMAS[2])
        return w0 + w1 + s0 + s1

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(*(jnp.asarray(x[n]) for n in names))
    ts = [_t(x[n]).requires_grad_() for n in names]
    c = None if ids is None else _t(ids)
    w0, w1, _ = pd.words_loss(ts[0], ts[1], _t(LENS), c, *GAMMAS)
    s0, s1 = pd.sent_loss(ts[2], ts[3], c, GAMMAS[2])
    pg = torch.autograd.grad(w0 + w1 + s0 + s1, ts)
    for n, g, r in zip(names, pg, jg):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-6 * np.abs(r).max(),
                                   err_msg=n)
    # padded word slots get no gradient
    assert not pg[1].numpy()[np.arange(T)[None, :] >= LENS[:, None]].any()
