"""The port's DAMSM image encoders (tgsr_tpu_torch/models/image_encoder.py)
against tgsr_tpu's on the CPU, float32: one JAX init of each family carried
across with `cnn_encoder_state_dict`, the same images.

Gates: SimpleCNNEncoder rtol = atol = 1e-4 (four convolutions and three BNs,
the blocks' gate), its train-mode running stats within 1e-5 (|stat| + 1);
CNNEncoder (94 convolutions and BNs deep) within 1e-4 of max |ref| in each
output, the float reassociation of the whole graph. The trees' leaf and
value counts are checked against `jax.eval_shape` of the full-width
modules (nef 256).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from tgsr_tpu.checkpoints import convert_torch, export_torch
from tgsr_tpu.models import image_encoder as jie
from tgsr_tpu_torch.checkpoints.from_jax import (cnn_encoder_state_dict, cnn_encoder_variables,
                                                 seeded_cnn_encoder_state_dict)
from tgsr_tpu_torch.checkpoints.reference import load_image_encoder
from tgsr_tpu_torch.models.image_encoder import CNNEncoder, SimpleCNNEncoder
from tests.torch_parity import _perturb
from tests.torch_train_parity import flat

torch.set_num_threads(1)
NEF, WIDTH = 32, 16
TOL = dict(rtol=1e-4, atol=1e-4)


def _tree(v, seed):
    return _perturb(unfreeze(jax.tree.map(np.asarray, v)), np.random.default_rng(seed))


def _images(b, size, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (b, size, size, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def simple():
    jm = jie.SimpleCNNEncoder(nef=NEF, width=WIDTH)
    v = _tree(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))), 0)
    return jm, v


@pytest.fixture(scope="module")
def inception():
    """The JAX CNNEncoder (nef 32) and its seeded tree; the init jitted."""
    jm = jie.CNNEncoder(nef=NEF)
    v = jax.jit(lambda k: jm.init(k, jnp.zeros((1, 299, 299, 3))))(jax.random.PRNGKey(1))
    return jm, _tree(v, 1)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("size", [32, 256])
def test_simple_cnn_matches_jax(simple, size, train):
    """32 px (an upsample to 137) and 256 px (an antialiased downsample)."""
    jm, v = simple
    x = _images(3, size, seed=size)
    pm = SimpleCNNEncoder(NEF, WIDTH)
    pm.load_state_dict(cnn_encoder_state_dict(v), strict=True)
    pm.train(train)
    with torch.no_grad():
        feat, code = pm(torch.from_numpy(x))
    if train:
        (jf, jc), upd = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        got = flat(cnn_encoder_variables(pm.state_dict())["batch_stats"])
        for k, ref in flat(upd["batch_stats"]).items():
            err = np.abs(got[k] - ref)
            assert (err <= 1e-5 * (np.abs(ref) + 1)).all(), (k, err.max())
    else:
        jf, jc = jm.apply(v, jnp.asarray(x))
        assert flat(cnn_encoder_variables(pm.state_dict())["batch_stats"]).keys() == \
            flat(v["batch_stats"]).keys()
    assert feat.shape == (3, 289, NEF) and code.shape == (3, NEF)
    np.testing.assert_allclose(feat.numpy(), np.asarray(jf), **TOL)
    np.testing.assert_allclose(code.numpy(), np.asarray(jc), **TOL)


def test_cnn_encoder_matches_jax(inception):
    """B = 1 at 299 px, eval mode: the Mixed_6e tap (before the head), the
    region features in JAX's (h, w) order and the code."""
    jm, v = inception
    x = _images(1, 299, seed=7)
    pm = CNNEncoder(NEF).eval()
    pm.load_state_dict(cnn_encoder_state_dict(v), strict=True)
    with torch.no_grad():
        feat, code = pm(torch.from_numpy(x))
        tap, pooled = pm.features_and_pooled(torch.from_numpy(x).permute(0, 3, 1, 2))
    jf, jc = jax.jit(lambda x: jm.apply(v, x))(jnp.asarray(x))
    jtap, jpooled = jax.jit(lambda x: jie.InceptionV3Backbone().apply(
        {"params": v["params"]["inception"], "batch_stats": v["batch_stats"]["inception"]},
        x))(jnp.asarray(x))
    for got, ref in ((tap.permute(0, 2, 3, 1), jtap), (pooled, jpooled), (feat, jf), (code, jc)):
        ref = np.asarray(ref)
        err = np.abs(got.numpy() - ref).max()
        assert got.shape == ref.shape and err <= 1e-4 * np.abs(ref).max(), (got.shape, err)


def test_freeze_backbone_gives_no_input_gradient(simple, inception):
    """CNNEncoder, its backbone always frozen (JAX's freeze_backbone=True),
    sends no gradient into its input, in both packages (JAX: stop_gradient;
    the port: no autograd); SimpleCNNEncoder does. The GAN trainer's DAMSM
    terms reach G through this input."""
    x = _images(1, 64, seed=3)
    for (jm, v), pm, frozen in ((inception, CNNEncoder(NEF), True),
                                (simple, SimpleCNNEncoder(NEF, WIDTH), False)):
        g = jax.jit(jax.grad(lambda x: sum(jnp.sum(o ** 2) for o in jm.apply(v, x))))(
            jnp.asarray(x))
        pm.load_state_dict(cnn_encoder_state_dict(v), strict=True)
        pm.eval()
        xt = torch.from_numpy(x).requires_grad_()
        out = pm(xt)
        loss = sum((o ** 2).sum() for o in out)
        if frozen:
            assert not np.asarray(g).any()
            assert not loss.requires_grad or torch.autograd.grad(
                loss, xt, allow_unused=True)[0] is None
        else:
            (gp,) = torch.autograd.grad(loss, xt)
            assert np.abs(np.asarray(g)).max() > 0
            np.testing.assert_allclose(gp.numpy(), np.asarray(g), rtol=1e-3,
                                       atol=1e-4 * np.abs(np.asarray(g)).max())


def test_state_dict_keys_match_exporter(inception):
    """cnn_encoder_state_dict gives export_cnn_encoder's keys, shapes and
    values (the reference's CNN_ENCODER names), loads strict, and
    round-trips through cnn_encoder_variables; JAX's convert_cnn_encoder
    reads it back to the same tree."""
    _, v = inception
    ref = export_torch.export_cnn_encoder(v)
    got = cnn_encoder_state_dict(v)
    assert {k: tuple(t.shape) for k, t in got.items()} == \
        {k: tuple(np.shape(a)) for k, a in ref.items()}
    for k, a in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(a), err_msg=k)
    CNNEncoder(NEF).load_state_dict(got, strict=True)
    back = cnn_encoder_variables(got)
    conv = convert_torch.convert_cnn_encoder({k: t.numpy() for k, t in got.items()})
    for tree in (back, conv):
        assert flat(tree).keys() == flat(v).keys()
        for k, a in flat(v).items():
            np.testing.assert_array_equal(flat(tree)[k], a, err_msg=k)


@pytest.mark.parametrize("family", ["inception", "simple"])
def test_converted_trees_carry_jax_counts(family):
    """At full width (nef 256) the port's converted trees carry the leaf and
    value counts of jax.eval_shape of the JAX module: CNNEncoder 285
    parameter leaves (22,506,720 values) and 188 stat leaves (34,432);
    SimpleCNNEncoder 13 (1,157,952) and 6 (896)."""
    if family == "inception":
        jm, pm, x = jie.CNNEncoder(nef=256), CNNEncoder(256), jnp.zeros((1, 299, 299, 3))
        want = (285, 22_506_720, 188, 34_432)
    else:
        jm, pm, x = jie.SimpleCNNEncoder(nef=256), SimpleCNNEncoder(256), jnp.zeros((1, 64, 64, 3))
        want = (13, 1_157_952, 6, 896)
    shapes = jax.eval_shape(lambda k: jm.init(k, x), jax.random.PRNGKey(0))
    tree = cnn_encoder_variables(pm.state_dict())

    def counts(t):
        p, s = jax.tree.leaves(t["params"]), jax.tree.leaves(t["batch_stats"])
        return len(p), sum(int(np.prod(a.shape)) for a in p), len(s), sum(
            int(np.prod(a.shape)) for a in s)

    assert counts(shapes) == want
    assert counts(tree) == want
    assert jax.tree.map(lambda a: tuple(a.shape), unfreeze(shapes)) == \
        jax.tree.map(lambda a: tuple(a.shape), tree)


def test_seeded_pth_loads_strict(tmp_path):
    """A seeded reference-named image_encoder .pth loads strict into
    CNNEncoder through load_image_encoder; a torchvision zoo file (fc. and
    AuxLogits, no heads) gives the backbone only; a .msgpack snapshot of
    either family gives its state dict."""
    from tgsr_tpu_torch.checkpoints.io import save_variables

    sd = seeded_cnn_encoder_state_dict(False, NEF, torch.Generator().manual_seed(0))
    path = str(tmp_path / "image_encoder7.pth")
    torch.save(sd, path)
    got = load_image_encoder(path)
    m = CNNEncoder(NEF)
    m.load_state_dict(got, strict=True)
    for k, t in sd.items():
        assert torch.equal(m.state_dict()[k], t), k
    zoo = {k: t for k, t in sd.items() if not k.startswith("emb_")}
    zoo.update({"fc.weight": torch.zeros(1000, 2048), "fc.bias": torch.zeros(1000),
                "AuxLogits.fc.weight": torch.zeros(1000, 768)})
    torch.save(zoo, str(tmp_path / "inception_v3_google.pth"))
    got = load_image_encoder(str(tmp_path / "inception_v3_google.pth"))
    assert set(got) == {k for k in sd if not k.startswith("emb_")}
    for simple in (True, False):
        sd = seeded_cnn_encoder_state_dict(simple, NEF, torch.Generator().manual_seed(1))
        path = str(tmp_path / f"image_encoder_{simple}.msgpack")
        save_variables(path, cnn_encoder_variables(sd))
        got = load_image_encoder(path)
        assert set(got) == set(sd)
        for k, t in sd.items():
            assert torch.equal(got[k], t), k
