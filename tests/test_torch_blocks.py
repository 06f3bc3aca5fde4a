"""tgsr_tpu_torch.ops.blocks against tgsr_tpu.ops.blocks on the CPU, f32.

Weights come from a seeded tgsr_tpu init carried across with the port's
converters; inputs from numpy. Gate rtol = atol = 1e-4, as
tests/test_pallas_up_head.py: float32 convolutions summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from tgsr_tpu.ops import blocks as jb
from tgsr_tpu_torch.checkpoints.from_jax import (_put_bn, _put_convs, _put_resblock_bn,
                                                 _resblock_sites)
from tgsr_tpu_torch.ops import blocks as tb
from tests.torch_parity import _perturb

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)


def _put_conv_bn(sd, prefix, params, stats, conv_idx, bn_idx):
    """An UpBlock's own tree -> `prefix.{conv_idx}.weight` and its BN."""
    _put_convs(sd, {"b": params}, {"b/conv": f"{prefix}.{conv_idx}"})
    _put_bn(sd, f"{prefix}.{bn_idx}", params["bn"], stats["bn"])


def _put_resblock(sd, prefix, params, stats):
    """A ResBlock's own tree -> Sequential(conv, BN, GLU, conv, BN) keys."""
    _put_convs(sd, {"b": params}, _resblock_sites("b", prefix))
    _put_resblock_bn(sd, prefix, params, stats)


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _to_nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("shape", [(2, 4, 4, 16), (3, 10)])
def test_glu(shape):
    x = _x(shape)
    np.testing.assert_allclose(tb.glu(torch.from_numpy(x)).numpy(),
                               np.asarray(jb.glu(jnp.asarray(x))), **TOL)


def test_upsample_nearest2x():
    x = _x((2, 3, 5, 4))
    np.testing.assert_array_equal(
        tb.upsample_nearest2x(torch.from_numpy(x)).numpy(),
        np.asarray(jb.upsample_nearest2x(jnp.asarray(x))))


@pytest.mark.parametrize("cin,cout,hw", [(16, 8, 8), (8, 8, 5)])
def test_upblock(cin, cout, hw):
    x = _x((2, hw, hw, cin), seed=1)
    jm = jb.UpBlock(cout)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = _perturb(unfreeze(jax.tree.map(np.asarray, v)), np.random.default_rng(2))
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))

    sd = {}
    _put_conv_bn(sd, "up", v["params"], v["batch_stats"], conv_idx=1, bn_idx=2)
    m = tb.UpBlock(cin, cout).eval()
    m.load_state_dict({k[len("up."):]: t for k, t in sd.items()}, strict=True)
    with torch.no_grad():
        got = _nhwc(m(_to_nchw(x)))
    assert got.shape == ref.shape == (2, 2 * hw, 2 * hw, cout)
    np.testing.assert_allclose(got, ref, **TOL)


def test_resblock():
    x = _x((2, 6, 6, 16), seed=3)
    jm = jb.ResBlock(16)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    v = _perturb(unfreeze(jax.tree.map(np.asarray, v)), np.random.default_rng(4))
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))

    sd = {}
    _put_resblock(sd, "block", v["params"], v["batch_stats"])
    m = tb.ResBlock(16).eval()
    m.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = _nhwc(m(_to_nchw(x)))
    np.testing.assert_allclose(got, ref, **TOL)


def _bf16_pair(which):
    """(JAX module, its variables, port module) of one block, BN perturbed."""
    if which == "upblock":
        x = _x((2, 8, 8, 16), seed=5)
        jm, m = jb.UpBlock(8), tb.UpBlock(16, 8)
    else:
        x = _x((2, 6, 6, 16), seed=6)
        jm, m = jb.ResBlock(16), tb.ResBlock(16)
    v = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    v = _perturb(unfreeze(jax.tree.map(np.asarray, v)), np.random.default_rng(7))
    sd = {}
    if which == "upblock":
        _put_conv_bn(sd, "up", v["params"], v["batch_stats"], conv_idx=1, bn_idx=2)
        sd = {k[len("up."):]: t for k, t in sd.items()}
    else:
        _put_resblock(sd, "block", v["params"], v["batch_stats"])
    m.load_state_dict(sd, strict=True)
    return x, jm, v, m.eval()


@pytest.mark.parametrize("which", ["upblock", "resblock"])
def test_blocks_bf16_match_jax_bf16(which):
    """The blocks and GLU run in bfloat16 on the CPU (conv, eval BN on
    bfloat16 statistics, GLU, nearest upsample) with every float parameter
    and buffer cast, as the bfloat16 pipeline casts them, against the JAX
    block on its bfloat16-cast variables. Gate: max abs difference at most
    2^-5 * max(1, |ref|max), a few bfloat16 steps: the frameworks round the
    conv sums, BN and GLU at other places."""
    from tgsr_tpu.engine.precision import cast_floats as jax_cast
    from tgsr_tpu_torch.engine.precision import cast_floats

    x, jm, v, m = _bf16_pair(which)
    xb = torch.from_numpy(x).bfloat16()
    xj = jnp.asarray(xb.float().numpy(), jnp.bfloat16)
    cast_floats(m, torch.bfloat16)
    with torch.no_grad():
        got = m(xb.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    for out, ref in ((got, jm.apply(jax_cast(v, jnp.bfloat16), xj)),
                     (tb.glu(xb), jb.glu(xj))):
        assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        ref = np.asarray(ref, np.float32)
        err = np.abs(out.float().numpy() - ref).max()
        assert err <= 2 ** -5 * max(1.0, np.abs(ref).max()), err
