"""The plain int8 convolution of tgsr_tpu_torch/ops/int8_conv.py against the
XLA int8 convolutions of tgsr_tpu/engine/quant.py, on seeded int8 inputs.

- int32 sums: equal to `jax.lax.conv_general_dilated(...,
  preferred_element_type=jnp.int32)` (NHWC, HWIO, SAME), for k 3 and 5,
  Cin 3 / 16 / 32, with and without `up2` (JAX: `upsample_nearest2x` of the
  int8 input first), values spanning -127..127 so that the sums are large;
- the dequantizing epilogue: within one ulp of the output dtype of
  `_int8_seg_fn` (with a folded BN, 3x3) and of `quant_conv` (no BN, 5x5),
  in float32 and bfloat16 (XLA may contract the BN's multiply-add);
- the kernel layout of the weight (`pack_int8_weight`) and the wrapper's
  refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgsr_tpu.engine import quant as jq
from tgsr_tpu.ops.blocks import upsample_nearest2x
from tgsr_tpu_torch.engine import quant as tq
from tgsr_tpu_torch.ops import _build
from tgsr_tpu_torch.ops.int8_conv import (dequant_epilogue, int8_conv, int8_conv_int32,
                                          pack_int8_weight)

torch.set_num_threads(1)


def _int8(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _ulps(got, ref, dtype):
    """|got - ref| in units of the output dtype's spacing at |ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    mant = 23 if dtype == "float32" else 7
    e = np.floor(np.log2(np.maximum(np.abs(ref), 1e-30)))
    return np.abs(got - ref) / 2.0 ** (e - mant)


@pytest.mark.parametrize("up2", [False, True])
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("cin", [3, 16, 32])
def test_int32_sums_equal_xla(cin, k, up2):
    rng = np.random.default_rng(cin * 10 + k + up2)
    x = _int8(rng, (2, 7, 9, cin))
    w = _int8(rng, (k, k, cin, 12))
    xj = jnp.asarray(x)
    if up2:
        xj = upsample_nearest2x(xj)
    ref = jax.lax.conv_general_dilated(
        xj, jnp.asarray(w), (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    got = int8_conv_int32(torch.from_numpy(x), torch.from_numpy(w), up2=up2)
    assert got.dtype == torch.int32 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("up2", [False, True])
def test_epilogue_matches_int8_seg_fn(out_dtype, up2):
    """3x3 with a folded BN, as the ResBlock / UpBlock int8 paths."""
    rng = np.random.default_rng(5 + up2)
    x = _int8(rng, (2, 6, 8, 16))
    w = rng.normal(0, 0.2, (3, 3, 16, 24)).astype(np.float32)
    wq, w_step = jq.quantize_kernel(jnp.asarray(w))
    x_step = jnp.asarray(0.031 / 127, jnp.float32)
    p = {"scale": 1 + rng.normal(0, 0.1, 24), "bias": rng.normal(0, 0.1, 24)}
    s = {"mean": rng.normal(0, 0.2, 24), "var": rng.uniform(0.5, 2, 24)}
    p, s = ({k: jnp.asarray(v, jnp.float32) for k, v in d.items()} for d in (p, s))
    affine = jq._bn_affine(p, s)
    inp = upsample_nearest2x(jnp.asarray(x)) if up2 else jnp.asarray(x)
    ref = jq._int8_seg_fn(inp, x_step, wq, w_step, affine, getattr(jnp, out_dtype))(0, 24)

    bn = tuple(torch.from_numpy(np.array(a)) for a in affine)
    scale = torch.from_numpy(np.array(x_step * w_step))
    wt = pack_int8_weight(torch.from_numpy(np.array(wq)))
    got = int8_conv(torch.from_numpy(x), wt, scale, bn=bn, up2=up2,
                    out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    assert _ulps(got.float().numpy(), np.asarray(ref.astype(jnp.float32)), out_dtype).max() <= 1


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_epilogue_matches_quant_conv(out_dtype):
    """5x5 without BN (conv_output): quant_conv quantizes x and the kernel
    itself; the port quantizes with its own quantize_act / quantize_kernel."""
    rng = np.random.default_rng(9)
    x = rng.normal(0, 1, (2, 10, 10, 32)).astype(np.float32)
    w = rng.normal(0, 0.05, (5, 5, 32, 3)).astype(np.float32)
    scale = 2.5
    ref = jq.quant_conv(jnp.asarray(x), jnp.asarray(w), scale, out_dtype=getattr(jnp, out_dtype))
    xq, x_step = tq.quantize_act(torch.from_numpy(x), scale)
    wq, w_step = tq.quantize_kernel(torch.from_numpy(w).permute(3, 2, 0, 1))
    got = int8_conv(xq, pack_int8_weight(wq.permute(2, 3, 1, 0).contiguous()),
                    x_step * w_step, out_dtype=getattr(torch, out_dtype))
    assert _ulps(got.float().numpy(), np.asarray(ref.astype(jnp.float32)), out_dtype).max() <= 1


def test_residual_is_added_after_the_cast():
    acc = torch.tensor([[1000, -7]], dtype=torch.int32)
    scale = torch.tensor([1e-3, 0.5])
    res = torch.tensor([[0.25, 3.0]], dtype=torch.bfloat16)
    got = dequant_epilogue(acc, scale, residual=res)
    want = (acc.float() * scale).bfloat16() + res
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_packed_weight_layout():
    """packed[ky, kx, g, co] holds channels 4g..4g+3 of (ky, kx, co), byte j
    = channel 4g + j (little-endian), Cin zero-padded to a multiple of 4."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(_int8(rng, (3, 3, 6, 5)))
    w = pack_int8_weight(q)
    assert w.packed.dtype == torch.int32 and tuple(w.packed.shape) == (3, 3, 2, 5)
    b = w.packed.contiguous().view(torch.uint8).reshape(3, 3, 2, 5, 4).to(torch.int32)
    b = torch.where(b > 127, b - 256, b)  # bytes back to int8 values
    unpacked = b.permute(0, 1, 2, 4, 3).reshape(3, 3, 8, 5)
    assert torch.equal(unpacked[:, :, :6], q.to(torch.int32))
    assert not unpacked[:, :, 6:].any()
    assert torch.equal(w.q, q)


def test_wrapper_refuses_and_counts_nothing_on_the_cpu():
    x = torch.zeros(1, 4, 4, 8, dtype=torch.int8)
    w = pack_int8_weight(torch.zeros(3, 3, 8, 4, dtype=torch.int8))
    scale = torch.ones(4)
    before = dict(_build.LAUNCHES)
    assert int8_conv(x, w, scale, up2=True).shape == (1, 8, 8, 4)
    assert _build.LAUNCHES == before  # the CPU runs the plain version
    with pytest.raises(TypeError, match="int8"):
        int8_conv(x.float(), w, scale)
    with pytest.raises(TypeError, match="out_dtype"):
        int8_conv(x, w, scale, out_dtype=torch.float16)
    with pytest.raises(TypeError, match="residual"):
        int8_conv(x, w, scale, residual=torch.zeros(1, 4, 4, 4), out_dtype=torch.float32)
    with pytest.raises(ValueError, match="no kernel"):
        int8_conv(x.to("meta"), w, scale)
