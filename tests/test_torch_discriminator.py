"""The port's DNet against tgsr_tpu's (tgsr_tpu/models/discriminator.py
:51-133) on the CPU, float32: one JAX init carried across with
`dnet_state_dict`, the same images and sentences, train mode (batch
statistics, the running stats updated as the trainer's D calls update them)
and eval mode. Gate rtol = atol = 1e-4 (four to eight stacked 4x4 / 3x3
convolutions and BNs, sums in another order; the blocks' gate). The state
dict round-trips through `dnet_variables`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgsr_tpu.models.discriminator import DNet as JDNet
from tgsr_tpu_torch.checkpoints.from_jax import dnet_state_dict, dnet_variables
from tgsr_tpu_torch.models.discriminator import DNet
from tests.torch_train_parity import flat

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
NDF, NEF, B = 8, 32, 3


def _nchw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)


@pytest.fixture(scope="module", params=[64, 128, 256])
def pair(request):
    size = request.param
    jd = JDNet(ndf=NDF, nef=NEF, img_size=size)
    rng = np.random.default_rng(size)
    img = rng.uniform(-1, 1, (B, size, size, 3)).astype(np.float32)
    sent = rng.normal(size=(B, NEF)).astype(np.float32)
    v = jax.tree.map(np.asarray, jd.init(jax.random.PRNGKey(size), jnp.asarray(img),
                                         jnp.asarray(sent), train=True))
    v = {"params": v["params"], "batch_stats": jax.tree.map(
        lambda a: a + rng.uniform(0.0, 0.5, a.shape).astype(np.float32), v["batch_stats"])}
    pd = DNet(ndf=NDF, nef=NEF, img_size=size)
    pd.load_state_dict(dnet_state_dict(v, size), strict=True)
    return size, jd, v, pd, img, sent


def test_state_dict_round_trips(pair):
    size, _, v, pd, _, _ = pair
    back = dnet_variables(pd.state_dict())
    assert flat(back).keys() == flat(v).keys()
    for k, a in flat(v).items():
        np.testing.assert_array_equal(flat(back)[k], a, err_msg=k)
    with pytest.raises(ValueError, match="px"):
        dnet_state_dict(v, size * 2)


@pytest.mark.parametrize("train", [True, False])
def test_dnet_matches_jax(pair, train):
    size, jd, v, pd, img, sent = pair
    pd.load_state_dict(dnet_state_dict(v, size), strict=True)
    pd.train(train)
    stats = v

    def jcall(method, *args):
        """JAX's D method on the stats so far; train mode threads the update."""
        nonlocal stats
        if not train:
            return jd.apply(v, *args, method=method, train=False)
        out, upd = jd.apply(stats, *args, method=method, train=True, mutable=["batch_stats"])
        stats = {**v, "batch_stats": upd["batch_stats"]}
        return out

    h_ref = jcall(JDNet.features, jnp.asarray(img))
    cond_ref = jcall(JDNet.cond_logit, h_ref, jnp.asarray(sent))
    unc_ref = jcall(JDNet.uncond_logit, h_ref)

    h = pd.features(_nchw(img))
    cond = pd.cond_logit(h, torch.from_numpy(sent))
    unc = pd.uncond_logit(h)
    np.testing.assert_allclose(h.permute(0, 2, 3, 1).detach().numpy(), np.asarray(h_ref), **TOL)
    np.testing.assert_allclose(cond.detach().numpy(), np.asarray(cond_ref), **TOL)
    np.testing.assert_allclose(unc.detach().numpy(), np.asarray(unc_ref), **TOL)
    assert h.shape == (B, NDF * 8, 4, 4)
    if train:
        got = flat(dnet_variables(pd.state_dict())["batch_stats"])
        for k, a in flat(stats["batch_stats"]).items():
            np.testing.assert_allclose(got[k], a, rtol=1e-5, atol=1e-6, err_msg=k)


def test_unconditional_dnet_matches_jax():
    """b_condition=False: no joint / cond_out, cond_logit refuses, the
    unconditional head as JAX's."""
    jd = JDNet(ndf=NDF, nef=NEF, img_size=64, b_condition=False)
    rng = np.random.default_rng(1)
    img = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    v = jax.tree.map(np.asarray, jd.init(jax.random.PRNGKey(1), jnp.asarray(img),
                                         jnp.zeros((2, NEF)), train=False))
    pd = DNet(ndf=NDF, nef=NEF, img_size=64, b_condition=False).eval()
    pd.load_state_dict(dnet_state_dict(v, 64), strict=True)
    cond_ref, unc_ref = jd.apply(v, jnp.asarray(img), jnp.zeros((2, NEF)), train=False)
    cond, unc = pd(_nchw(img), torch.zeros(2, NEF))
    assert cond is None and cond_ref is None
    np.testing.assert_allclose(unc.detach().numpy(), np.asarray(unc_ref), **TOL)
    with pytest.raises(ValueError, match="no conditional head"):
        pd.cond_logit(pd.features(_nchw(img)), torch.zeros(2, NEF))


@pytest.mark.parametrize("ndf,size", [(8, 16), (16, 8), (12, 16), (16, 32)])
def test_bf16_logits_on_the_cpu(ndf, size):
    """The bfloat16 DNet on the CPU, train mode, fed channels_last as the
    trainer feeds it (an NHWC image permuted): both logits within 0.03 of
    the float64 DNet on the same bfloat16-rounded weights and image. Its
    4x4, stride-4 logit convs see ndf (8 px), 2 ndf (16 px) or 4 ndf (32
    px) channels; PyTorch's CPU bfloat16 convolution sums a channels_last
    input of 16 or 24 channels there wrongly (`_logit_input`)."""
    rng = np.random.default_rng(size + ndf)
    torch.manual_seed(size + ndf)
    d = DNet(ndf=ndf, nef=NEF, img_size=size).to(torch.bfloat16).train()
    img = torch.from_numpy(rng.uniform(-1, 1, (B, size, size, 3)).astype(np.float32))
    sent = torch.from_numpy(rng.normal(size=(B, NEF)).astype(np.float32))
    x = img.permute(0, 3, 1, 2).to(torch.bfloat16)
    assert x.is_contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        h = d.features(x)
        got = [d.cond_logit(h, sent.to(torch.bfloat16)), d.uncond_logit(h)]
        d64 = d.double()
        h = d64.features(x.double())
        ref = [d64.cond_logit(h, sent.to(torch.bfloat16).double()), d64.uncond_logit(h)]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.double().numpy(), r.numpy(), rtol=0, atol=0.03)
