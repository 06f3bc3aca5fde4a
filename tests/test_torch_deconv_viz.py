"""Deconvnet visualisation in tgsr_tpu_torch (`utils/deconv_viz.py`) against
tgsr_tpu's (`tgsr_tpu/utils/deconv_viz.py`): the ReLU whose backward is
relu(g), the seed selection of every mode, `forward_to_tap` and `vis_layer`
at two layers (layer 3 crosses a max-pool) in every mode ('max', 'mean',
'four', 'all'): the same uint8 image within 1 level and the same max
activation. The port's VGG16Features carries the weights; JAX reads them
through `checkpoints.from_jax.vgg16_variables`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgsr_tpu.utils import deconv_viz as jdv
from tgsr_tpu_torch.checkpoints.from_jax import vgg16_variables
from tgsr_tpu_torch.models.vgg import VGG16Features
from tgsr_tpu_torch.utils import deconv_viz as tdv

torch.set_num_threads(1)
MODES = ("max", "mean", "four", "all")


@pytest.fixture(scope="module")
def vgg():
    torch.manual_seed(0)
    net = VGG16Features().eval()
    with torch.no_grad():  # small weights keep the activations in range, as a trained VGG's
        for m in net.features:
            if isinstance(m, torch.nn.Conv2d):
                m.weight.mul_(0.5)
                m.bias.normal_(0, 0.01)
    params = vgg16_variables(net.state_dict())["params"]
    x = np.random.default_rng(0).uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    return net, params, x


def test_deconv_relu_rectifies_the_gradient():
    rng = np.random.default_rng(1)
    x, g = rng.normal(size=(5, 7)).astype(np.float32), rng.normal(size=(5, 7)).astype(np.float32)
    y, vjp = jax.vjp(jdv.deconv_relu, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = tdv.deconv_relu(xt)
    (gt,) = torch.autograd.grad(yt, xt, grad_outputs=torch.from_numpy(g))
    np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(y))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))


@pytest.mark.parametrize("mode", MODES)
def test_select_seed_matches_jax(mode):
    fmap = np.maximum(np.random.default_rng(2).normal(size=(6, 6, 8)), 0).astype(np.float32)
    seed, max_act = tdv._select_seed(fmap, mode)
    ref, ref_max = jdv._select_seed(fmap, mode)
    np.testing.assert_array_equal(seed, ref)
    assert max_act == ref_max


@pytest.mark.parametrize("layer", [1, 3])
def test_forward_to_tap_matches_jax(vgg, layer):
    net, params, x = vgg
    ref = np.asarray(jdv.forward_to_tap(params, jnp.asarray(x), layer))
    with torch.no_grad():
        got = tdv.forward_to_tap(net, torch.from_numpy(x), layer).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("layer", [1, 3])
@pytest.mark.parametrize("mode", MODES)
def test_vis_layer_matches_jax(vgg, layer, mode):
    net, params, x = vgg
    ref_img, ref_max = jdv.vis_layer(params, jnp.asarray(x), layer, mode=mode)
    img, max_act = tdv.vis_layer(net, x[0], layer, mode=mode)
    assert img.shape == ref_img.shape == (16, 16, 3) and img.dtype == np.uint8
    assert max_act == ref_max
    assert np.abs(img.astype(int) - ref_img.astype(int)).max() <= 1


def test_layer_out_of_range(vgg):
    with pytest.raises(ValueError, match="layer must be in"):
        tdv.forward_to_tap(vgg[0], torch.zeros(1, 8, 8, 3), 13)
