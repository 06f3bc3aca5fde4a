"""The library variants of the HF branch (no JAX entry point builds them)
against tgsr_tpu's on the CPU, float32, rtol = atol = 1e-4:

- `NetGHigh` (tgsr_tpu/models/generator_hf.py:150), additive, from the LR's
  blur or the LR less it, and its `cat` mode (convin and the two residual
  sequences read 6 channels, no ResBlocks);
- `NetGHighSRWeight` (:212), residual1 and residual one module;
- `NetGHigh16` (tgsr_tpu/models/models16.py:72), the upscale blocks tied and
  the residual sequences tied;
- `NetGHighWeight16(fix_bugs=True)` (:164-166), where residual816 and
  upscale16x make the 512 px step, with the scalar `a` and with weight maps.

Seeded port weights (BN statistics and affine moved away from (0, 1)) go to
JAX through JAX's own converters of the reference's files
(convert_netgh_weight, convert_netgh_sr_weight, convert_netgh_weight16), so
each test also shows that the port module's state dict is the reference
layout those converters read.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgsr_tpu.checkpoints.convert_torch import (convert_netgh_sr_weight, convert_netgh_weight,
                                                convert_netgh_weight16)
from tgsr_tpu.models.generator_hf import NetGHigh as JNetGHigh
from tgsr_tpu.models.generator_hf import NetGHighSRWeight as JNetGHighSRWeight
from tgsr_tpu.models.models16 import NetGHigh16 as JNetGHigh16
from tgsr_tpu.models.models16 import NetGHighWeight16 as JNetGHighWeight16
from tgsr_tpu.ops.image import gaussian_blur as jblur
from tgsr_tpu_torch.checkpoints.from_jax import _seed_module
from tgsr_tpu_torch.models.generator_hf import NetGHigh, NetGHighSRWeight, lr_blur
from tgsr_tpu_torch.models.models16 import NetGHigh16, NetGHighWeight16

torch.set_num_threads(1)
MOD = dict(rtol=1e-4, atol=1e-4)
NGF = 8


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _seeded(module, seed):
    sd = _seed_module(module, torch.Generator().manual_seed(seed))
    return module.eval(), {k: v.numpy() for k, v in sd.items()}


def _data(lr_size, sizes, seed):
    rng = np.random.default_rng(seed)
    lr = rng.uniform(-1, 1, (2, lr_size, lr_size, 3)).astype(np.float32)
    srb = [rng.uniform(-1, 1, (2, s, s, 3)).astype(np.float32) for s in sizes]
    blur = _nhwc(lr_blur(_nchw(lr)))
    return lr, srb, blur


def _close(got, ref):
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(_nhwc(g), np.asarray(r), **MOD, err_msg=f"scale {i}")


@pytest.mark.parametrize("low", [False, True])
def test_netg_high_matches_jax(low):
    m, sd = _seeded(NetGHigh(NGF), 1)
    lr, srb, blur = _data(8, (16, 32, 64), 1)
    v = convert_netgh_weight(sd)
    v["params"].pop("a")
    ref = JNetGHigh(ngf=NGF).apply(v, lr, srb, blur, low=low)
    with torch.no_grad():
        got = m(_nchw(lr), [_nchw(s) for s in srb], _nchw(blur), low=low)
    _close(got, ref)
    np.testing.assert_allclose(blur, np.asarray(jblur(jnp.asarray(lr), 2.0)), **MOD)


def test_netg_high_cat_matches_jax():
    """cat mode: [LR - blur, blur] into convin, [image, srb] into the
    residual sequences, 6 input channels each."""
    m, sd = _seeded(NetGHigh(NGF, cat=True), 2)
    assert sd["convin.0.weight"].shape[1] == 6 and sd["residual24.0.weight"].shape[1] == 6
    lr, srb, blur = _data(8, (16, 32, 64), 2)
    v = convert_netgh_weight(sd, n_res=0)
    v["params"].pop("a")
    ref = JNetGHigh(ngf=NGF, cat=True).apply(v, lr, srb, blur)
    with torch.no_grad():
        got = m(_nchw(lr), [_nchw(s) for s in srb], _nchw(blur))
    _close(got, ref)


def test_netg_high_sr_weight_matches_jax():
    """The tied residual: the state dict carries residual1 and residual, one
    set of tensors, and JAX's converter reads `residual`."""
    m, sd = _seeded(NetGHighSRWeight(NGF, size=64), 3)
    assert m.residual1 is m.residual
    np.testing.assert_array_equal(sd["residual1.0.weight"], sd["residual.0.weight"])
    with torch.no_grad():
        m.a.copy_(1 + torch.rand(64, 64, generator=torch.Generator().manual_seed(3)) - 0.5)
    sd["a"] = m.a.detach().numpy()
    lr, srb, _ = _data(8, (64,), 3)
    ims_r, a_r = JNetGHighSRWeight(ngf=NGF, size=64).apply(convert_netgh_sr_weight(sd), lr, srb,
                                                           lr)
    with torch.no_grad():
        ims, a = m(_nchw(lr), [_nchw(srb[0])])
    _close(ims, ims_r)
    np.testing.assert_array_equal(a.detach().numpy(), np.asarray(a_r))


@pytest.mark.parametrize("low", [False, True])
def test_netg_high16_matches_jax(low):
    """Every upscale block one module, every residual sequence one module:
    the state dict's alias key sets carry the same tensors."""
    m, sd = _seeded(NetGHigh16(NGF), 4)
    assert m.upscale8x is m.upscale2x and m.residual48 is m.residual24
    np.testing.assert_array_equal(sd["upscale8x.1.weight"], sd["upscale2x.1.weight"])
    lr, srb, blur = _data(4, (8, 16, 32, 64), 4)
    v = convert_netgh_weight16(sd)
    v["params"].pop("a")
    ref = JNetGHigh16(ngf=NGF).apply(v, lr, srb, blur, low=low)
    with torch.no_grad():
        got = m(_nchw(lr), [_nchw(s) for s in srb], _nchw(blur), low=low)
    _close(got, ref)


@pytest.mark.parametrize("weightmap", [False, True])
def test_netgh_weight16_fix_bugs_matches_jax(weightmap):
    """fix_bugs=True: residual816 and upscale16x run, the 512 px image is
    blended with srb[3] (the scalar `a`, or a4)."""
    sizes = (8, 16, 32, 64)
    m, sd = _seeded(NetGHighWeight16(NGF, low="lr-lrblur", weightmap=weightmap, sizes=sizes,
                                     fix_bugs=True), 5)
    assert {"residual816.0.weight", "upscale16x.1.weight"} <= set(sd)
    lr, srb, blur = _data(4, sizes, 5)
    if not weightmap:
        m.a.fill_(0.3)
        sd["a"] = np.full((1,), 0.3, np.float32)
    v = convert_netgh_weight16(sd, weightmap=weightmap)
    ref, _, _ = JNetGHighWeight16(ngf=NGF, weightmap=weightmap, low="lr-lrblur", sizes=sizes,
                                  fix_bugs=True).apply(v, lr, srb, blur)
    with torch.no_grad():
        got = m(_nchw(lr), [_nchw(s) for s in srb])
    _close(got, ref)
