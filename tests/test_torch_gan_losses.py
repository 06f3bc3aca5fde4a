"""The port's GAN and pixel losses (tgsr_tpu_torch/losses) against
tgsr_tpu.losses (gan.py :22-142, pixel.py :16-62) on the CPU, float32, on the
same numpy inputs. The discriminator closures are the same small linear maps
on both sides (features = a projection of the image, cond = features . u +
sent . v, uncond = features . w), so that the losses' own arithmetic, the
mismatched pair at b - 1 and the weighting are what is compared, values and
gradients. Gate rtol = atol = 1e-5 (means over the batch in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgsr_tpu.losses import gan as jgan
from tgsr_tpu.losses import pixel as jpix
from tgsr_tpu_torch.losses import gan, pixel

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
B, F_DIM, E = 4, 6, 5


def _closures(xp, proj, u, v, w, with_uncond):
    """(d_features, d_cond, d_uncond) on NHWC images, in numpy's `xp`."""
    def d_features(img):
        return xp.mean(img, axis=(1, 2)) @ proj

    def d_cond(h, sent):
        return h @ u + sent @ v

    def d_uncond(h):
        return h @ w

    return d_features, d_cond, d_uncond if with_uncond else None


def _weights(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in ((3, F_DIM), (F_DIM,), (E,), (F_DIM,))]


def _both(seed, with_uncond):
    w = _weights(seed)
    return (_closures(jnp, *map(jnp.asarray, w), with_uncond),
            _closures(torch, *map(torch.from_numpy, w), with_uncond))


def test_bce_with_logits_matches_jax_and_torch():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=64) * 30).astype(np.float32)  # saturated logits too
    t = rng.integers(0, 2, 64).astype(np.float32)
    got = gan.bce_with_logits(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(got.item(), float(jgan.bce_with_logits(jnp.asarray(x), jnp.asarray(t))),
                               **TOL)
    np.testing.assert_allclose(got.item(), torch.nn.functional.binary_cross_entropy_with_logits(
        torch.from_numpy(x), torch.from_numpy(t)).item(), **TOL)


@pytest.mark.parametrize("with_uncond", [True, False])
def test_discriminator_loss_matches_jax(with_uncond):
    rng = np.random.default_rng(1)
    real, fake = (rng.uniform(-1, 1, (B, 8, 8, 3)).astype(np.float32) for _ in range(2))
    sent = rng.normal(size=(B, E)).astype(np.float32)
    jd, td = _both(2, with_uncond)
    ref = jgan.discriminator_loss(*jd, jnp.asarray(real), jnp.asarray(fake), jnp.asarray(sent))
    fake_t = torch.from_numpy(fake).requires_grad_()
    got = gan.discriminator_loss(*td, torch.from_numpy(real), fake_t, torch.from_numpy(sent))
    np.testing.assert_allclose(got.item(), float(ref), **TOL)
    assert not got.requires_grad  # the fake images are detached


@pytest.mark.parametrize("with_uncond", [True, False])
def test_generator_loss_matches_jax(with_uncond):
    rng = np.random.default_rng(3)
    fakes = [rng.uniform(-1, 1, (B, s, s, 3)).astype(np.float32) for s in (8, 16)]
    sent = rng.normal(size=(B, E)).astype(np.float32)
    ds_j, ds_t = zip(*(_both(10 + i, with_uncond) for i in range(2)))

    def jloss(fs):
        return jgan.generator_loss(list(ds_j), None, fs, jnp.asarray(sent), None, None, None,
                                   g=0.7)

    (ref, ref_logs), ref_grads = jax.value_and_grad(jloss, has_aux=True)(
        [jnp.asarray(f) for f in fakes])
    fk = [torch.from_numpy(f).requires_grad_() for f in fakes]
    got, logs = gan.generator_loss(list(ds_t), None, fk, torch.from_numpy(sent), g=0.7)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), **TOL)
    assert sorted(logs) == sorted(ref_logs) == ["g_loss0", "g_loss1"]
    for k in logs:
        np.testing.assert_allclose(logs[k].item(), float(ref_logs[k]), **TOL)
    for f, r in zip(fk, ref_grads):
        np.testing.assert_allclose(f.grad.numpy(), np.asarray(r), **TOL)


def test_generator_loss_with_an_image_encoder_is_refused():
    """An image encoder without the words and lengths its DAMSM terms read
    is refused (the terms themselves: the next test)."""
    _, td = _both(4, True)
    with pytest.raises(ValueError, match="words_embs and cap_lens"):
        gan.generator_loss([td], lambda img: img, [torch.zeros(2, 8, 8, 3)], torch.zeros(2, E))


@pytest.mark.parametrize("class_ids", [None, [0, 1, 0, 2]], ids=["no-classes", "classes"])
def test_generator_loss_damsm_terms_match_jax(class_ids):
    """generator_loss with an image encoder (the same linear map of the
    finest fake to 289 regions and a code on both sides): the words and
    sentence terms times w, s and SMOOTH.LAMBDA inside the total, JAX's
    logs, and the gradient into the fake images."""
    jd, td = _both(6, True)
    rng = np.random.default_rng(7)
    fake = [rng.uniform(-1, 1, (B, s, s, 3)).astype(np.float32) for s in (8, 16)]
    sent = rng.normal(size=(B, E)).astype(np.float32)
    words = rng.normal(size=(B, 6, E)).astype(np.float32)
    lens = np.array([6, 1, 3, 4], np.int32)
    pr, pc = (rng.normal(size=s).astype(np.float32) for s in ((3, 289 * E), (3, E)))

    def encoder(xp, pr, pc):
        def enc(img):
            m = xp.mean(img, axis=(1, 2))
            return (m @ pr).reshape(img.shape[0], 289, E), m @ pc
        return enc

    kw = dict(gammas=(4.0, 5.0, 10.0), smooth_lambda=2.0, w=0.5, s=3.0)
    cls = None if class_ids is None else np.asarray(class_ids, np.int32)

    def jtotal(fake):
        return jgan.generator_loss([jd, jd], encoder(jnp, jnp.asarray(pr), jnp.asarray(pc)), fake,
                                   jnp.asarray(sent), jnp.asarray(words), jnp.asarray(lens),
                                   None if cls is None else jnp.asarray(cls), **kw)

    (jt, jlogs), jgrad = jax.value_and_grad(jtotal, has_aux=True)([jnp.asarray(f) for f in fake])
    tf = [torch.from_numpy(f).requires_grad_() for f in fake]
    tt, tlogs = gan.generator_loss(
        [td, td], encoder(torch, torch.from_numpy(pr), torch.from_numpy(pc)), tf,
        torch.from_numpy(sent), torch.from_numpy(words), torch.from_numpy(lens),
        None if cls is None else torch.from_numpy(cls), **kw)
    assert set(tlogs) == set(jlogs) == {"g_loss0", "g_loss1", "w_loss", "s_loss"}
    np.testing.assert_allclose(tt.item(), float(jt), **TOL)
    for k in jlogs:
        np.testing.assert_allclose(tlogs[k].item(), float(jlogs[k]), **TOL)
    for f, r in zip(torch.autograd.grad(tt, tf), jgrad):
        np.testing.assert_allclose(f.numpy(), np.asarray(r), rtol=1e-4, atol=1e-6)


def test_pixel_losses_match_jax():
    rng = np.random.default_rng(5)
    fake = [rng.uniform(-1, 1, (B, s, s, 3)).astype(np.float32) for s in (16, 32)]
    real = [rng.uniform(-1, 1, (B, s, s, 3)).astype(np.float32) for s in (16, 32)]
    lr = rng.uniform(-1, 1, (B, 8, 8, 3)).astype(np.float32)
    attn = [rng.dirichlet(np.ones(6), (B, s, s)).transpose(0, 3, 1, 2).astype(np.float32)
            for s in (8, 16)]
    mu, logvar = (rng.normal(0, 0.5, (B, 10)).astype(np.float32) for _ in range(2))
    t = lambda xs: [torch.from_numpy(x) for x in xs]
    j = lambda xs: [jnp.asarray(x) for x in xs]
    np.testing.assert_allclose(pixel.mse_pyramid(t(fake), t(real)).item(),
                               float(jpix.mse_pyramid(j(fake), j(real))), **TOL)
    np.testing.assert_allclose(pixel.kl_loss(torch.from_numpy(mu), torch.from_numpy(logvar)).item(),
                               float(jpix.kl_loss(jnp.asarray(mu), jnp.asarray(logvar))), **TOL)
    np.testing.assert_allclose(pixel.cycle_mse(t(fake), torch.from_numpy(lr)).item(),
                               float(jpix.cycle_mse(j(fake), jnp.asarray(lr))), **TOL)
    got, w_got = pixel.weight_mse(t(fake), t(real), t(attn))
    ref, w_ref = jpix.weight_mse(j(fake), j(real), j(attn))
    np.testing.assert_allclose(got.item(), float(ref), **TOL)
    np.testing.assert_allclose(w_got.numpy(), np.asarray(w_ref), **TOL)


def test_weight_mse_puts_a_gradient_on_the_attention_map():
    """weight_mse's gradient reaches the attention maps (the max over
    words), which the attention kernel's backward takes on the card."""
    rng = np.random.default_rng(6)
    fake, real = (torch.from_numpy(rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32))
                  for _ in range(2))
    a = torch.from_numpy(rng.dirichlet(np.ones(6), (2, 8, 8)).transpose(0, 3, 1, 2)
                         .astype(np.float32)).requires_grad_()
    loss, _ = pixel.weight_mse([fake], [real], [a])
    loss.backward()
    ref = jax.grad(lambda x: jpix.weight_mse([jnp.asarray(fake.numpy())],
                                             [jnp.asarray(real.numpy())], [x])[0])(
        jnp.asarray(a.detach().numpy()))
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(ref), **TOL)
