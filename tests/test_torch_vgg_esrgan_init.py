"""`VGG16Features` (models/vgg.py), `ESRGANDNet` (models/discriminator.py) and
`orthogonal_reinit` (utils/init.py) of tgsr_tpu_torch against tgsr_tpu on
the CPU, f32.

- VGG16: seeded port weights through JAX's `convert_vgg16` (which reads the
  port's state dict as it reads torchvision's), the five taps at 32 and
  64 px within rtol = atol = 1e-4; `vgg16_variables` equal to
  `convert_vgg16` and `vgg16_state_dict` its inverse, bit for bit; a
  torchvision-shaped state dict (with `classifier.`) loads strict after
  `load_torchvision_vgg16`.
- ESRGANDNet at ndf 8: logits in eval mode and, in train mode, logits and
  the BN running statistics within 1e-4, on a JAX tree carried across by
  `library_state_dict`.
- orthogonal_reinit: on JAX's [fan_in, fan_out] view every conv and Linear
  kernel has orthonormal columns (Q^T Q = I, or rows where fan_in <
  fan_out) within 1e-5; BN scales have mean 1 and std 0.02 within their
  sampling error; biases are 0; and the leaves it changes are the leaves
  JAX's `orthogonal_reinit` changes on the matching tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from tgsr_tpu.models.discriminator import ESRGANDNet as JESRGANDNet
from tgsr_tpu.models.text_encoder import TextEncoder as JTextEncoder
from tgsr_tpu.models.variants import InitStageGImg as JInitStageGImg
from tgsr_tpu.models.vgg import VGG16Features as JVGG16Features
from tgsr_tpu.models.vgg import convert_vgg16
from tgsr_tpu.utils.init import orthogonal_reinit as jax_orthogonal_reinit
from tgsr_tpu_torch.checkpoints.from_jax import (_seed_module, library_state_dict,
                                                 library_variables, text_state_dict,
                                                 text_variables, vgg16_state_dict,
                                                 vgg16_variables)
from tgsr_tpu_torch.models.discriminator import ESRGANDNet
from tgsr_tpu_torch.models.text_encoder import TextEncoder
from tgsr_tpu_torch.models.variants import InitStageGImg
from tgsr_tpu_torch.models.vgg import CONV_INDICES, VGG16Features, load_torchvision_vgg16
from tgsr_tpu_torch.utils.init import orthogonal_reinit
from tests.torch_parity import _perturb
from tests.torch_train_parity import flat

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def vgg():
    m = VGG16Features().eval()
    _seed_module(m, torch.Generator().manual_seed(0))
    return m


@pytest.mark.parametrize("size", [32, 64])
def test_vgg16_taps_match_jax(vgg, size):
    x = np.random.default_rng(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    ref = JVGG16Features().apply(convert_vgg16(vgg.state_dict()), jnp.asarray(x))
    with torch.no_grad():
        got = vgg(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(ref) == 5
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape[2] == size >> i
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(r),
                                   err_msg=f"tap {i}", **TOL)


def test_vgg16_weights_cross_both_ways(vgg):
    sd = vgg.state_dict()
    assert sorted(sd) == sorted(f"features.{i}.{p}" for i in CONV_INDICES
                                for p in ("weight", "bias"))
    ref = convert_vgg16(sd)
    got = vgg16_variables(sd)
    assert flat(got).keys() == flat(ref).keys()
    for k, v in flat(ref).items():
        assert np.array_equal(flat(got)[k], v), k
    back = vgg16_state_dict(ref)
    assert all(torch.equal(back[k], sd[k]) for k in sd) and back.keys() == sd.keys()
    zoo = {**sd, "classifier.0.weight": torch.zeros(4, 4), "classifier.0.bias": torch.zeros(4)}
    VGG16Features().load_state_dict(load_torchvision_vgg16(zoo), strict=True)


def _esrgan_tree(x):
    v = JESRGANDNet(ndf=8).init(jax.random.PRNGKey(0), jnp.asarray(x))
    return _perturb(unfreeze(jax.tree.map(np.asarray, v)), np.random.default_rng(1))


@pytest.mark.parametrize("train", [False, True])
def test_esrgan_dnet_matches_jax(train):
    x = np.random.default_rng(2).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    variables = _esrgan_tree(x)
    m = ESRGANDNet(ndf=8)
    m.load_state_dict(library_state_dict(m, variables), strict=True)
    with torch.no_grad():
        got = m.train(train)(torch.from_numpy(x).permute(0, 3, 1, 2))
    if train:
        ref, upd = JESRGANDNet(ndf=8).apply(variables, jnp.asarray(x), train=True,
                                            mutable=["batch_stats"])
        stats = flat(library_variables(m)["batch_stats"])
        ref_stats = flat(jax.tree.map(np.asarray, unfreeze(upd["batch_stats"])))
        assert stats.keys() == ref_stats.keys() and len(stats) == 6
        for k, v in ref_stats.items():
            np.testing.assert_allclose(stats[k], v, err_msg=k, **TOL)
    else:
        ref = JESRGANDNet(ndf=8).apply(variables, jnp.asarray(x))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _changed(before, after):
    return {k for k in before if not np.array_equal(before[k], after[k])}


def _kernels(module):
    """(name, JAX's [fan_in, fan_out] view) of every conv and Linear weight."""
    for name, m in module.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            yield name, m.weight.detach().permute(2, 3, 1, 0).reshape(-1, m.weight.shape[0])
        elif isinstance(m, torch.nn.Linear):
            yield name, m.weight.detach().t()


def test_orthogonal_reinit_properties_and_leaves():
    """ESRGANDNet (convs, BN, Linears with biases) and InitStageGImg (BN,
    the attention's word projection, ResBlocks): orthonormal kernels, BN
    scales N(1, 0.02), zero biases; and JAX's rule changes the same leaves
    of the matching trees (running statistics in neither)."""
    x = np.random.default_rng(2).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    lr = jnp.zeros((1, 8, 8, 3))
    words, mask = jnp.zeros((1, 6, 12)), jnp.zeros((1, 6), bool)
    cases = [(ESRGANDNet(ndf=8), _esrgan_tree(x)),
             (InitStageGImg(8, 2, cdf=12), _perturb(unfreeze(jax.tree.map(
                 np.asarray, JInitStageGImg(8, 2).init(jax.random.PRNGKey(3), lr, words,
                                                       mask))), np.random.default_rng(4)))]
    scales = []
    for m, variables in cases:
        m.load_state_dict(library_state_dict(m, variables), strict=True)
        orthogonal_reinit(m, torch.Generator().manual_seed(5))
        jax_params = jax_orthogonal_reinit(variables["params"], jax.random.PRNGKey(6))
        ref = _changed(flat(variables["params"]), flat(jax.tree.map(np.asarray, jax_params)))
        after = library_variables(m)
        assert _changed(flat(variables["params"]), flat(after["params"])) == ref
        assert not _changed(flat(variables["batch_stats"]), flat(after["batch_stats"]))
        for name, q in _kernels(m):
            q = q.double()
            gram = q.t() @ q if q.shape[0] >= q.shape[1] else q @ q.t()
            torch.testing.assert_close(gram, torch.eye(gram.shape[0], dtype=torch.float64),
                                       rtol=0, atol=1e-5, msg=name)
        for mod in m.modules():
            if getattr(mod, "bias", None) is not None:
                assert not mod.bias.any()
            if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
                scales.append(mod.weight.detach())
    s = torch.cat(scales).double()
    n = s.numel()
    assert abs(s.mean().item() - 1.0) < 4 * 0.02 / n ** 0.5
    assert abs(s.std().item() - 0.02) < 4 * 0.02 / (2 * n) ** 0.5


def test_orthogonal_reinit_leaves_recurrent_weights():
    """A text encoder holds no conv, Linear or BN: JAX's rule leaves its tree
    as it is (its leaves are `embedding`, `w_ih_fwd`, `b_ih_fwd`, ...), and
    so does the port's."""
    v = JTextEncoder(vocab_size=11, nhidden=16, rnn_type="GRU").init(
        jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32), jnp.ones((1,), jnp.int32))
    v = jax.tree.map(np.asarray, unfreeze(v))
    assert not _changed(flat(v["params"]), flat(jax.tree.map(np.asarray, jax_orthogonal_reinit(
        v["params"], jax.random.PRNGKey(1)))))
    m = TextEncoder(11, 300, 16, rnn_type="GRU")
    m.load_state_dict(text_state_dict(v), strict=True)
    orthogonal_reinit(m, torch.Generator().manual_seed(1))
    assert not _changed(flat(v["params"]), text_variables(m.state_dict())["params"])
