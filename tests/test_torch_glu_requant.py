"""The plain GLU+requantize of tgsr_tpu_torch/ops/glu_requant.py against
JAX versions of the same pass, on seeded bfloat16 inputs, at both kernel
layouts (c = 64: `glu_requant_one`, c = 32: `glu_requant_pair`).

The port rounds as the probe's `_glu_q` writes it: s = bf16(sigmoid(f32 g)),
v * s rounded to bf16, divided by the step, rounded half to even. Gates:

- the probe's `_glu_q` (examples/glu_pallas_probe.py, step 0.02), eager:
  equal, element for element;
- `_glu_q` under jit, and the probe's Pallas kernels `glu_requant_one` /
  `glu_requant_pair` in interpret mode (the probe module's `pl` replaced,
  for the test, by a shim whose `pallas_call` passes interpret=True;
  examples/ is untouched): XLA keeps the product v * s in float32 there
  (excess precision: the bf16 convert pair is dropped), which moves about
  4 % of the elements by one step at this step size. Each version is held
  exactly against a numpy model of its own rounding order (product rounded
  to bf16 for the port, not rounded for XLA), so every difference between
  them is that rounding and nothing else;
- tgsr_tpu/engine/quant.py's own pass, `v * jax.nn.sigmoid(g)` in bfloat16
  then `quantize_act`: JAX's bf16 logistic on the CPU rounds exp, 1 + and
  1 / each to bfloat16, so its gate differs from the port's correctly
  rounded one in about a third of the elements. Eager, the int8 results
  are equal wherever the two gates are equal, and at most two steps apart
  elsewhere; under jit, at most two steps apart, at most 10 % of the
  elements differ and at most 1e-4 by two steps (measured: 7-8 % and
  1e-5).
"""

import functools
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgsr_tpu.engine.quant import quantize_act
from tgsr_tpu_torch.engine.quant import act_step
from tgsr_tpu_torch.ops import _build
from tgsr_tpu_torch.ops.glu_requant import glu_requant, glu_requant_plain

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4096  # pixels


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location(
        "glu_pallas_probe", os.path.join(ROOT, "examples", "glu_pallas_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    pl = mod.pl
    mod.pl = types.SimpleNamespace(BlockSpec=pl.BlockSpec,
                                   pallas_call=functools.partial(pl.pallas_call, interpret=True))
    return mod


def _h(c, seed, scale=1.5):
    rng = np.random.default_rng(seed)
    h = (rng.normal(0, scale, (N, 2 * c))).astype(np.float32)
    return np.asarray(jnp.asarray(h).astype(jnp.bfloat16).astype(jnp.float32))


def _port(h, scale):
    return glu_requant_plain(torch.from_numpy(h.copy()).bfloat16(), scale).numpy()


def _model(h, c, step, round_product):
    """numpy: s = bf16(sigmoid(g)) (float32 sigmoid), p = v * s (exact in
    float32), optionally rounded to bf16, q = rint(clip(p / step))."""
    bf16 = lambda x: np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    v, g = h[:, :c], h[:, c:]
    s = bf16(torch.sigmoid(torch.from_numpy(g.copy())).numpy())
    p = v * s
    if round_product:
        p = bf16(p)
    return np.round(np.clip(p / np.float32(step), -127, 127)).astype(np.int8)


@pytest.mark.parametrize("c", [64, 32])
def test_matches_probe_glu_q_and_pallas_interpret(probe, c):
    scale = probe.STEP * 127.0  # the probe's step, 0.02
    assert np.float32(act_step(scale)) == np.float32(probe.STEP)
    h = _h(c, seed=c)
    got = _port(h, scale)
    hj = jnp.asarray(h).astype(jnp.bfloat16)
    np.testing.assert_array_equal(got, np.asarray(probe._glu_q(hj[:, :c], hj[:, c:])))
    np.testing.assert_array_equal(got, _model(h, c, probe.STEP, round_product=True))
    xla = _model(h, c, probe.STEP, round_product=False)
    kernel = probe.glu_requant_one if c == 64 else probe.glu_requant_pair
    out = kernel(hj, c, 512)
    assert out.shape == (N, c) and out.dtype == jnp.int8
    np.testing.assert_array_equal(np.asarray(out), xla)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(probe._glu_q)(hj[:, :c], hj[:, c:])), xla)
    d = np.abs(got.astype(np.int32) - xla.astype(np.int32))
    assert d.max() == 1 and 0 < (d > 0).mean() < 0.1


@pytest.mark.parametrize("c", [64, 32])
@pytest.mark.parametrize("jit", [False, True])
def test_matches_quant_pass(c, jit):
    """quant.py:239-241 then quantize_act (:137-142), at a calibrated scale
    that clips the tail."""
    h = _h(c, seed=10 + c)
    scale = 2.0

    def ref(hj):
        return quantize_act(hj[:, :c] * jax.nn.sigmoid(hj[:, c:]), scale)[0]

    hj = jnp.asarray(h).astype(jnp.bfloat16)
    want = np.asarray((jax.jit(ref) if jit else ref)(hj)).astype(np.int32)
    got = _port(h, scale)
    d = np.abs(got.astype(np.int32) - want)
    assert d.max() <= 2
    if jit:
        assert (d > 0).mean() <= 0.1 and (d > 1).mean() <= 1e-4
    else:
        s_jax = np.asarray(jax.nn.sigmoid(hj[:, c:]).astype(jnp.float32))
        s_port = torch.sigmoid(torch.from_numpy(h[:, c:].copy())).bfloat16().float().numpy()
        assert not np.any((d > 0) & (s_jax == s_port))
    assert np.abs(got).max() == 127  # the clip is exercised


def test_rounds_half_to_even_after_the_division():
    """v * s lands exactly on k + .5 steps (a power-of-two step, sigmoid 1):
    rint, not round-half-away."""
    scale = 127.0 / 64  # step 2^-6, exact
    v = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 300.0]) / 64
    g = torch.full_like(v, 100.0)  # sigmoid = 1 exactly in float32 and bfloat16
    h = torch.cat([v, g]).reshape(1, 12).bfloat16()
    np.testing.assert_array_equal(glu_requant_plain(h, scale)[0].numpy(),
                                  [0, 2, 2, 0, -2, 127])


def test_wrapper_refuses_and_counts_nothing_on_the_cpu():
    before = dict(_build.LAUNCHES)
    h = torch.zeros(8, 64, dtype=torch.bfloat16)
    assert glu_requant(h, 1.0).shape == (8, 32)
    assert _build.LAUNCHES == before  # the CPU runs the plain version
    with pytest.raises(TypeError, match="bfloat16"):
        glu_requant(h.float(), 1.0)
    with pytest.raises(ValueError, match="no kernel"):
        glu_requant(h.to("meta"), 1.0)
