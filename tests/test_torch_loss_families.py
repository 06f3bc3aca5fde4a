"""The GAN loss families of tgsr_tpu_torch/losses/gan.py beyond the trainer's
(the "or", unconditional, ESRGAN and relativistic families, `oneim`,
`generator_loss`'s `word_scale`) and losses/mani.py, against tgsr_tpu's on
the CPU, f32.

The discriminators, image encoder and VGG are small closures written once
for each package on the same numpy weights (a tanh of the pooled image
through a matrix; regions and code from the image's pixels), so that every
loss runs its whole composition. Gate rtol = atol = 1e-4 on the value, on
every logged term and on the gradients: of the G losses with respect to the
fake images, of the D losses with respect to the D weights (the detached
fakes give none, in both packages). The relativistic D loss is NaN in any
non-degenerate regime in both (JAX's docstring), and is held to that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgsr_tpu.losses import gan as jgan
from tgsr_tpu.losses import mani as jmani
from tgsr_tpu_torch.losses import gan as tgan
from tgsr_tpu_torch.losses import mani as tmani

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
B, T, E, F, R = 3, 6, 8, 5, 9
SIZES = (4, 8)
LENS = np.array([6, 3, 1], np.int32)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.normal(size=s).astype(np.float32)
    return {
        "fakes": [n(B, s, s, 3) for s in SIZES], "reals": [n(B, s, s, 3) for s in SIZES],
        "sent": n(B, E), "words": n(B, T, E), "word_scale": rng.uniform(0.5, 1.5, (B, T)).astype(
            np.float32),
        "class_ids": np.array([1, 2, 1], np.int32),
        "d": [{"wf": n(3, F), "wc": n(F), "ws": n(E) * 0.3, "wu": n(F)} for _ in SIZES],
        "enc": {"we": n(3, E), "wcode": n(E, E) * 0.3},
    }


def _closures(xp, d, enc):
    """(ds, image_encoder, vgg_apply) for xp = jnp or torch."""
    mean = (lambda x: jnp.mean(x, axis=(1, 2))) if xp is jnp else (lambda x: x.mean(dim=(1, 2)))

    def scale(p):
        feat = lambda img: xp.tanh(mean(img) @ p["wf"])
        cond = lambda f, sent: f @ p["wc"] + sent @ p["ws"]
        uncond = lambda f: f @ p["wu"]
        return feat, cond, uncond

    def image_encoder(img):
        regions = img.reshape(img.shape[0], -1, 3)[:, :R] @ enc["we"]
        code = (regions.mean(axis=1) if xp is jnp else regions.mean(dim=1)) @ enc["wcode"]
        return regions, code

    vgg = lambda img: [img * 2.0, xp.tanh(img)]
    return [scale(p) for p in d], image_encoder, vgg


# name -> (the call, given (the package's module, xp, inputs, ds, image
# encoder, vgg); what the gradient is taken of: the fakes or D's weights)
CASES = {
    "generator_loss word_scale": (lambda m, xp, v, ds, enc, vgg: m.generator_loss(
        ds, enc, v["fakes"], v["sent"], v["words"], v["lens"], v["class_ids"],
        word_scale=v["word_scale"]), "fakes"),
    "generator_loss_oneim": (lambda m, xp, v, ds, enc, vgg: m.generator_loss_oneim(
        ds[-1], enc, v["fakes"], v["sent"], v["words"], v["lens"], v["class_ids"]), "fakes"),
    "discriminator_loss_sigmoid": (lambda m, xp, v, ds, enc, vgg: m.discriminator_loss_sigmoid(
        *ds[-1], v["reals"][-1], v["fakes"][-1], v["sent"]), "d"),
    "generator_loss_sigmoid": (lambda m, xp, v, ds, enc, vgg: m.generator_loss_sigmoid(
        ds, enc, v["fakes"], v["sent"], v["words"], v["lens"], v["class_ids"], s=0.5), "fakes"),
    "generator_loss_sigmoid w 0": (lambda m, xp, v, ds, enc, vgg: m.generator_loss_sigmoid(
        ds, enc, v["fakes"], v["sent"], v["words"], v["lens"], v["class_ids"], w=0.0), "fakes"),
    "generator_loss_wordsent_only": (lambda m, xp, v, ds, enc, vgg:
                                     m.generator_loss_wordsent_only(
                                         enc, v["fakes"], v["sent"], v["words"], v["lens"],
                                         v["class_ids"], smooth_lambda=2.0, w=0.7), "fakes"),
    "generator_loss_no_wordsent": (lambda m, xp, v, ds, enc, vgg: m.generator_loss_no_wordsent(
        ds, v["fakes"], v["sent"], g=0.5), "fakes"),
    "generator_loss_face": (lambda m, xp, v, ds, enc, vgg: m.generator_loss_face(
        ds, enc, v["fakes"], v["sent"], v["words"], v["lens"], v["class_ids"],
        smooth_lambda=2.0, g=[0.5, 1.5]), "fakes"),
    "generator_loss_uncond": (lambda m, xp, v, ds, enc, vgg: m.generator_loss_uncond(
        ds, v["fakes"]), "fakes"),
    "discriminator_loss_uncond": (lambda m, xp, v, ds, enc, vgg: m.discriminator_loss_uncond(
        ds[0][0], ds[0][2], v["reals"][0], v["fakes"][0]), "d"),
    "esrgan_g_loss": (lambda m, xp, v, ds, enc, vgg: m.esrgan_g_loss(
        lambda x: ds[1][2](ds[1][0](x)), v["fakes"][1], v["reals"][1]), "d"),
    "esrgan_d_loss": (lambda m, xp, v, ds, enc, vgg: m.esrgan_d_loss(
        lambda x: ds[1][2](ds[1][0](x)), v["reals"][1], v["fakes"][1]), "d"),
    "relativistic_g_loss": (lambda m, xp, v, ds, enc, vgg: m.relativistic_g_loss(
        ds[0][0], ds[0][2], v["fakes"][0], v["reals"][0]), "d"),
    "relativistic_d_loss": (lambda m, xp, v, ds, enc, vgg: m.relativistic_d_loss(
        ds[0][0], ds[0][2], v["reals"][0], v["fakes"][0]), "d"),
    "discriminator_loss_mani": (lambda m, xp, v, ds, enc, vgg: m.discriminator_loss_mani(
        *ds[-1], v["reals"][-1], v["fakes"][-1], v["sent"], enc, v["words"], v["lens"]), "d"),
    "generator_loss_mani": (lambda m, xp, v, ds, enc, vgg: m.generator_loss_mani(
        ds, enc, vgg, v["fakes"], v["reals"], v["sent"], v["words"], v["lens"],
        v["class_ids"], smooth_lambda=2.0), "fakes"),
    "dcm_generator_loss": (lambda m, xp, v, ds, enc, vgg: m.dcm_generator_loss(
        *ds[-1], enc, v["fakes"][-1], v["sent"], v["words"], v["lens"], v["class_ids"]),
        "fakes"),
}
MANI = {"discriminator_loss_mani", "generator_loss_mani", "dcm_generator_loss"}


def _module(name, jax_side):
    if name in MANI:
        return jmani if jax_side else tmani
    return jgan if jax_side else tgan


def _split(out):
    return out if isinstance(out, tuple) else (out, {})


def _relativistic_inputs(v):
    """The relativistic G loss is defined only where sigmoid(D(fake)) >
    sigmoid(D(real)) everywhere: shift the fakes so that D's uncond logit of
    every fake exceeds every real's."""
    v = dict(v)
    v["fakes"] = [f + 3.0 * np.sign(v["d"][0]["wf"] @ v["d"][0]["wu"])[None, None, None]
                  for f in v["fakes"]]
    return v


def _jax(name, v):
    fn, wrt = CASES[name]
    m = _module(name, True)

    def total(fakes, d):
        vv = dict(v, fakes=fakes, d=d)
        ds, enc, vgg = _closures(jnp, d, v["enc"])
        return _split(fn(m, jnp, vv, ds, enc, vgg))

    jv = jax.tree.map(jnp.asarray, v)
    out, logs = total(jv["fakes"], jv["d"])
    argnum = 0 if wrt == "fakes" else 1
    grad = jax.grad(lambda f, d: total(f, d)[0], argnums=argnum)(jv["fakes"], jv["d"])
    return np.asarray(out), {k: np.asarray(x) for k, x in logs.items()}, jax.tree.map(
        np.asarray, grad)


def _torch(name, v):
    fn, wrt = CASES[name]
    m = _module(name, False)
    tv = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), v)
    leaves = tv["fakes"] if wrt == "fakes" else [x for p in tv["d"] for x in p.values()]
    for x in leaves:
        x.requires_grad_(True)
    tv["lens"] = tv["lens"].long()
    ds, enc, vgg = _closures(torch, tv["d"], tv["enc"])
    out, logs = _split(fn(m, torch, tv, ds, enc, vgg))
    grads = torch.autograd.grad(out, leaves, allow_unused=True)
    grads = [np.zeros(x.shape, np.float32) if g is None else g.numpy() for x, g in
             zip(leaves, grads)]
    if wrt == "d":
        it = iter(grads)
        grads = [{k: next(it) for k in p} for p in tv["d"]]
    return out.detach().numpy(), {k: x.detach().numpy() for k, x in logs.items()}, grads


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_matches_jax(name):
    v = dict(_data(), lens=LENS)
    if name == "relativistic_g_loss":
        v = _relativistic_inputs(v)
    ref, ref_logs, ref_grad = _jax(name, v)
    got, logs, grad = _torch(name, v)
    if name == "relativistic_d_loss":
        assert np.isnan(ref) and np.isnan(got)
        return
    assert np.isfinite(got)
    np.testing.assert_allclose(got, ref, **TOL)
    assert sorted(logs) == sorted(ref_logs)
    for k in logs:
        np.testing.assert_allclose(logs[k], ref_logs[k], err_msg=k, **TOL)
    for i, (g, r) in enumerate(zip(jax.tree.leaves(grad), jax.tree.leaves(ref_grad))):
        np.testing.assert_allclose(g, r, err_msg=f"grad {i}", **TOL)


def test_word_scale_moves_the_words_loss():
    """word_scale reaches the words loss (so the check above is not vacuous)."""
    v = dict(_data(), lens=LENS)
    _, plain, _ = _torch("generator_loss_oneim", v)
    _, scaled, _ = _torch("generator_loss word_scale", v)
    assert abs(float(plain["w_loss"]) - float(scaled["w_loss"])) > 1e-3


def test_word_level_correlation_value_without_gradient():
    """Its value against JAX's with labels of both kinds, and no gradient
    to the image features or the words in either package."""
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(B, R, E)).astype(np.float32)
    words = rng.normal(size=(B, T, E)).astype(np.float32)
    labels = np.array([1.0, 0.0, 1.0], np.float32)
    lens = np.array([6, 0, 2], np.int32)
    f = lambda a, w: jmani.word_level_correlation(a, w, jnp.asarray(lens), jnp.asarray(labels))
    ref = f(jnp.asarray(feats), jnp.asarray(words))
    jg = jax.grad(lambda a, w: f(a, w), argnums=(0, 1))(jnp.asarray(feats), jnp.asarray(words))
    tf, tw = torch.tensor(feats, requires_grad=True), torch.tensor(words, requires_grad=True)
    got = tmani.word_level_correlation(tf, tw, torch.from_numpy(lens).long(),
                                       torch.from_numpy(labels))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    assert not got.requires_grad and all(not np.asarray(g).any() for g in jg)


@pytest.mark.parametrize("fn", ["bce_on_sigmoid", "bce_on_probs"])
def test_bce_helpers(fn):
    rng = np.random.default_rng(4)
    x = (rng.uniform(0.01, 0.99, 7) if fn == "bce_on_probs" else rng.normal(size=7)).astype(
        np.float32)
    y = np.array([1, 0, 1, 1, 0, 0, 1], np.float32)
    x[0] = 0.0 if fn == "bce_on_probs" else x[0]  # log(0) floored at -100, as torch's
    ref = getattr(jgan, fn)(jnp.asarray(x), jnp.asarray(y))
    got = getattr(tgan, fn)(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    if fn == "bce_on_probs":
        assert np.isnan(tgan.bce_on_probs(torch.tensor([-0.5]), torch.tensor([1.0])).item())
