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

`requant` (the requantization alone, the int8 path's `quantize_act`) is
held equal to tgsr_tpu's `quantize_act`, eager and under jit, bit for bit
over every finite bfloat16. The kernel divides by multiplying with the
reciprocal of the step and falls back to IEEE division near a half-integer
(csrc/glu_requant.cu `quant`); that rule, written here in numpy float32, is
held equal to division-then-rint over every finite bfloat16 at several
steps.
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
from tgsr_tpu_torch.ops.glu_requant import glu_requant, glu_requant_plain, requant, requant_plain

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4096  # pixels
# scales whose step = scale / 127 is a power of two (2^-6: every tie lands
# exactly) and calibrated-looking ones
POW2_SCALE, CAL_SCALE = 127.0 / 64, 3.0
# a scale at which p * (1 / step) alone, without the guard, rounds 4 finite
# bfloat16 to another int8 than division does (found by search)
MISROUND_SCALE = 14.741072019324145


def _finite_bf16():
    """Every finite bfloat16 (65,280 of the 65,536 bit patterns), as float32."""
    bits = np.arange(1 << 16, dtype=np.uint32)
    bits = bits[((bits >> 7) & 0xFF) != 0xFF]
    return (bits << 16).view(np.float32)


def _guarded_quotient(p, step):
    """csrc/glu_requant.cu `quant` in numpy float32: t = p * r with r = 1 /
    step rounded once; IEEE p / step where |t| < 256 and |t| lies within
    2^-20 |t| of a half-integer. Returns the quotient and where it divided."""
    p, step = p.astype(np.float32), np.float32(step)
    with np.errstate(over="ignore", invalid="ignore"):
        t = p * (np.float32(1) / step)
        a = np.abs(t)
        near = (a < 256) & (np.abs((a - np.floor(a)) - np.float32(0.5))
                            <= a * np.float32(2.0 ** -20))
        return np.where(near, p / step, t), near


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
    assert glu_requant(h.float(), 1.0).shape == (8, 32)
    assert _build.LAUNCHES == before  # the CPU runs the plain version
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        glu_requant(h.half(), 1.0)
    with pytest.raises(ValueError, match="no kernel"):
        glu_requant(h.to("meta"), 1.0)


@pytest.mark.parametrize("jit", [False, True])
@pytest.mark.parametrize("scale", [POW2_SCALE, CAL_SCALE])
def test_requant_matches_jax_quantize_act_on_every_bf16(scale, jit):
    x = _finite_bf16()
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    fn = (lambda v: quantize_act(v, scale)[0])
    want = np.asarray((jax.jit(fn) if jit else fn)(xj))
    got = requant(torch.from_numpy(x).bfloat16(), scale)
    assert got.dtype == torch.int8 and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.min() == -127 and want.max() == 127 and np.any(want == 0)


@pytest.mark.parametrize("scale", [POW2_SCALE, CAL_SCALE, MISROUND_SCALE, 0.7316, 255.0])
def test_divide_guard_equals_ieee_division(scale):
    """The kernel's multiply-with-guard gives the bits of division then
    rint over every finite bfloat16 (the GLU product p is a bfloat16 too),
    and divides for a small share of them."""
    p = _finite_bf16()
    step = np.float32(act_step(scale))
    t, near = _guarded_quotient(p, step)
    with np.errstate(over="ignore", invalid="ignore"):
        exact = p / step
        want = np.rint(np.clip(exact, -127, 127)).astype(np.int8)
        ties = np.abs(exact - np.floor(exact)) == 0.5
    np.testing.assert_array_equal(np.rint(np.clip(t, -127, 127)).astype(np.int8), want)
    assert near.mean() < 0.01
    if scale == POW2_SCALE:  # exact ties exist and take the division
        assert ties.any() and near[ties].all()
    if scale == MISROUND_SCALE:  # the guard is needed
        with np.errstate(over="ignore"):
            bare = np.rint(np.clip(p * (np.float32(1) / step), -127, 127)).astype(np.int8)
        assert (bare != want).sum() == 4


def test_requant_wrapper_refuses_and_counts_nothing_on_the_cpu():
    before = dict(_build.LAUNCHES)
    x = torch.linspace(-3, 3, 21).bfloat16().reshape(3, 7)  # 21: not a multiple of 8
    np.testing.assert_array_equal(requant(x, 2.0).numpy(), requant_plain(x, 2.0).numpy())
    np.testing.assert_array_equal(requant(x.float(), 2.0).numpy(),
                                  requant_plain(x.float(), 2.0).numpy())
    assert _build.LAUNCHES == before  # the CPU runs the plain version
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        requant(x.double(), 2.0)
    with pytest.raises(ValueError, match="no kernel"):
        requant(x.to("meta"), 2.0)


# -- the float32 instances (int8 serving with float32 compute) ---------------

def _near_half(p, step, rel=2.0 ** -20):
    """Where p / step lies within `rel` of it of a half-integer (float64)."""
    t = np.abs(p.astype(np.float64) / np.float64(step))
    return np.abs(t - np.floor(t) - 0.5) <= rel * t


@pytest.mark.parametrize("c", [64, 32])
@pytest.mark.parametrize("jit", [False, True])
def test_f32_glu_matches_res_block_split_order(c, jit):
    """float32 h: the port's plain GLU+requantize (s = sigmoid(g),
    p = v * s, q = rint(clip(p / step))) against JAX's float32 order in
    `_res_block_split` and the UpBlock split, `v * jax.nn.sigmoid(g)` then
    `quantize_act`. The two sigmoids may differ in their last bit, which
    moves q by at most one step, and only where p / step lies within
    2^-20 of a half-integer; everywhere else the int8 is equal."""
    rng = np.random.default_rng(20 + c)
    h = rng.normal(0, 1.5, (N, 2 * c)).astype(np.float32)
    scale = 2.0

    def ref(hj):
        return quantize_act(hj[:, :c] * jax.nn.sigmoid(hj[:, c:]), scale)[0]

    want = np.asarray((jax.jit(ref) if jit else ref)(jnp.asarray(h))).astype(np.int32)
    got = glu_requant_plain(torch.from_numpy(h), scale)
    assert got.dtype == torch.int8 and got.shape == (N, c)
    d = np.abs(got.numpy().astype(np.int32) - want)
    p = h[:, :c] * torch.sigmoid(torch.from_numpy(h[:, c:])).numpy()
    assert d.max() <= 1
    assert np.all(_near_half(p, act_step(scale))[d > 0])
    assert np.abs(want).max() == 127  # the clip is exercised


@pytest.mark.parametrize("jit", [False, True])
@pytest.mark.parametrize("scale", [POW2_SCALE, CAL_SCALE, MISROUND_SCALE])
def test_requant_f32_matches_jax_quantize_act(scale, jit):
    """float32 x, spread over every binade from 2^-30 to 2^10 with both
    signs, zeros and exact half-steps: bit for bit tgsr_tpu's eager
    quantize_act. Under jit XLA multiplies by the reciprocal of the constant
    step instead of dividing, which for float32 inputs (unlike bfloat16
    ones) moves q by one step where x / step lies within 2^-20 of a
    half-integer, and nowhere else."""
    rng = np.random.default_rng(7)
    step = np.float32(act_step(scale))
    x = np.concatenate([
        rng.uniform(1, 2, 1 << 16).astype(np.float32)
        * np.exp2(rng.integers(-30, 11, 1 << 16)).astype(np.float32)
        * rng.choice(np.float32([-1, 1]), 1 << 16),
        (np.arange(-130, 130, dtype=np.float32) + np.float32(0.5)) * step,
        np.float32([0.0, -0.0, 1e-38, -1e-38, 3e38, -3e38])])
    fn = (lambda v: quantize_act(v, scale)[0])
    want = np.asarray((jax.jit(fn) if jit else fn)(jnp.asarray(x)))
    got = requant(torch.from_numpy(x), scale)
    if jit:
        d = np.abs(got.numpy().astype(np.int32) - want)
        assert d.max() <= 1 and np.all(_near_half(x, step)[d > 0])
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    assert want.min() == -127 and want.max() == 127 and np.any(want == 0)


@pytest.mark.parametrize("scale", [POW2_SCALE, CAL_SCALE, MISROUND_SCALE, 0.7316, 255.0])
def test_divide_guard_equals_ieee_division_f32(scale):
    """The kernel's multiply-with-guard on float32 products (the float32
    instances' p is any float32): division-then-rint bit for bit over a
    million float32 drawn across the int8 range, and over the float32
    neighbours of every half-step, where the guard must divide."""
    rng = np.random.default_rng(8)
    step = np.float32(act_step(scale))
    half = (np.arange(-128, 128, dtype=np.float64) + 0.5) * np.float64(step)
    near = np.float32(half)
    for _ in range(6):
        near = np.concatenate([near, np.nextafter(near, np.float32(np.inf)),
                               np.nextafter(near, np.float32(-np.inf))])
    p = np.concatenate([rng.uniform(-140, 140, 1 << 20).astype(np.float32) * step, near])
    t, divided = _guarded_quotient(p, step)
    with np.errstate(over="ignore", invalid="ignore"):
        want = np.rint(np.clip(p / step, -127, 127)).astype(np.int8)
    np.testing.assert_array_equal(np.rint(np.clip(t, -127, 127)).astype(np.int8), want)
    assert divided[-len(near):].mean() > 0.5 and divided[:1 << 20].mean() < 0.01
