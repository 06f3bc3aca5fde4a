"""The conv probe's plain versions (tgsr_tpu_torch/ops/conv_probe.py) against
the Pallas kernels of examples/pallas_conv_probe.py, on seeded bfloat16
inputs at B = 2, 32 x 32.

The probe module is loaded into a module object of the test's own and only
that object is patched (examples/ is untouched): its sizes (B, H, W and NT =
H // TILE; PTILE is 32, so H must be a multiple of 32), and its `pl`, by a
shim whose `pallas_call` passes interpret=True. `im2col` is called with
interpret=True itself, since its explicit interpret=False would override
the shim.

Gate: within one bf16 ulp elementwise (`conv_probe.max_ulps`, the ulp taken
of max(|ref|, 2^-10 max|ref|)). Both sides sum exact products of bf16
values in float32, in another order, and round to bf16 once.
"""

import functools
import importlib.util
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tgsr_tpu_torch.ops import _build
from tgsr_tpu_torch.ops import conv_probe as cp
from tgsr_tpu_torch.probes import conv_probe as probe_path

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, W = 2, 32, 32


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location(
        "pallas_conv_probe", os.path.join(ROOT, "examples", "pallas_conv_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.B, mod.H, mod.W = B, H, W
    mod.NT = mod.H // mod.TILE
    mod.pl = types.SimpleNamespace(BlockSpec=pl.BlockSpec, ds=pl.ds, program_id=pl.program_id,
                                   pallas_call=functools.partial(pl.pallas_call, interpret=True))
    return mod


def _bf16(shape, sd, seed):
    """Seeded normal values rounded to bf16, as float32 numpy."""
    a = np.random.default_rng(seed).normal(0, sd, shape).astype(np.float32)
    return torch.from_numpy(a).bfloat16().float().numpy()


@pytest.fixture(scope="module")
def inputs(probe):
    x = _bf16((B, H, W, 64), 0.1, 0)
    w = _bf16((3, 3, 64, 128), 0.05, 1)
    p = _bf16((B * probe.NT, probe.TILE * W, 640), 0.1, 2)
    return x, w, p


def _t(a):
    return torch.from_numpy(a).bfloat16()


def _j(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def test_pack_w_equals_probe_byte_for_byte(probe, inputs):
    w = inputs[1]
    want = np.asarray(probe._pack_w(_j(w))).view(np.uint16)
    got = cp.pack_w(_t(w)).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)
    assert not got[576:].any()  # the duplicated tap's half is zero


def test_hwio_weight_is_pack_w_without_its_tenth_half(inputs):
    """The HWIO weight seen as [576, 128] is `pack_w`'s first 576 rows byte
    for byte (tap j in rows 64j .. 64j + 63 of both), the fact that lets tap9
    and pair5 share one kernel body over 9 and 10 halves of the weight."""
    w = _t(inputs[1])
    got = w.reshape(576, 128).view(torch.int16)
    want = cp.pack_w(w)[:576].view(torch.int16)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["tap9", "im2col", "pair5", "dotceil"])
def test_plain_matches_pallas_interpret(probe, inputs, name):
    x, w, p = inputs
    wp = probe._pack_w(_j(w))
    if name == "tap9":
        want = probe.tap9(_j(x), _j(w))
    elif name == "im2col":
        want = probe.im2col(_j(x), wp, interpret=True)
    elif name == "pair5":
        want = probe.pair5(_j(x), wp)
    else:
        want = probe.dotceil(_j(p), wp)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    wpt = cp.pack_w(_t(w))
    got = {"tap9": lambda: cp.tap9_plain(_t(x), _t(w)),
           "im2col": lambda: cp.im2col_plain(_t(x), wpt),
           "pair5": lambda: cp.pair5_plain(_t(x), wpt),
           "dotceil": lambda: cp.dotceil_plain(_t(p), wpt)}[name]()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert cp.max_ulps(got, want) <= 1
    # and the conv rows against the probe's own reference, lax.conv in float32 sums
    if name != "dotceil":
        xla = torch.from_numpy(np.array(probe.xla_conv(_j(x), _j(w)).astype(jnp.float32)))
        assert cp.max_ulps(got, xla) <= 1


def test_formulations_agree_and_the_dummy_half_is_inert(inputs):
    """tap9, im2col and pair5 compute one conv; the packed weight's zero
    half makes the duplicated tap add nothing."""
    x, w, _ = map(_t, inputs)
    wp = cp.pack_w(w)
    ref = cp.tap9_plain(x, w)
    for got in (cp.im2col_plain(x, wp), cp.pair5_plain(x, wp)):
        assert cp.max_ulps(got, ref) <= 1
    wp_dirty = wp.clone()
    wp_dirty[576:] = 1.0
    assert cp.max_ulps(cp.im2col_plain(x, wp_dirty), ref) > 1


def test_max_ulps_counts_bf16_ulps():
    ref = torch.tensor([1.0, -2.0, 0.5, 2.0 ** -20]).bfloat16()
    one_up = torch.tensor([1.0 + 2 ** -7, -2.0, 0.5 - 2 ** -9, 0.0]).bfloat16()
    # 2^-20 lies below the floor 2^-10 * 2: its ulp there is 2^-10 / 2^7
    assert cp.max_ulps(one_up, ref) == pytest.approx(1.0)
    two_up = torch.tensor([1.0 + 2 ** -6, -2.0, 0.5, 2.0 ** -20]).bfloat16()
    assert cp.max_ulps(two_up, ref) == pytest.approx(2.0)


@pytest.mark.parametrize("name", ["tap9", "im2col", "pair5", "dotceil"])
def test_wrappers_run_plain_on_the_cpu_and_count_nothing(inputs, name):
    x, w, p = map(_t, inputs)
    wp = cp.pack_w(w)
    args = {"tap9": (x, w), "im2col": (x, wp), "pair5": (x, wp), "dotceil": (p, wp)}[name]
    before = dict(_build.LAUNCHES)
    got = getattr(cp, name)(*args)
    assert _build.LAUNCHES == before
    assert torch.equal(got, getattr(cp, f"{name}_plain")(*args))


def test_shape_checks_raise():
    x = torch.zeros(1, 8, 32, 64, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 64, 128, dtype=torch.bfloat16)
    wp = torch.zeros(640, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="Cin 64"):
        cp.tap9(torch.zeros(1, 8, 32, 32, dtype=torch.bfloat16), w)
    with pytest.raises(ValueError, match="Cout 128"):
        cp.tap9(x, torch.zeros(3, 3, 64, 64, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="multiple of 4"):
        cp.im2col(torch.zeros(1, 6, 32, 64, dtype=torch.bfloat16), wp)
    with pytest.raises(ValueError, match="of 32"):
        cp.pair5(torch.zeros(1, 8, 48, 64, dtype=torch.bfloat16), wp)
    with pytest.raises(ValueError, match="640"):
        cp.dotceil(torch.zeros(4, 576, dtype=torch.bfloat16), wp)
    with pytest.raises(ValueError, match="pack_w"):
        cp.pack_w(torch.zeros(3, 3, 32, 128))
    with pytest.raises(TypeError, match="bfloat16"):
        cp.pair5(x.float(), wp)
    with pytest.raises(ValueError, match="no kernel"):
        cp.tap9(x.to("meta"), w.to("meta"))


def test_probe_path_runs_on_the_cpu():
    out = probe_path.main(device="cpu", b=2, h=32, w=32)
    assert out["device"] == "cpu" and out["shape"] == [2, 32, 32]
    assert out["decision"] is None  # nothing is timed without a card
    assert set(out["rows"]) == {"conv_library", "tap9", "im2col", "pair5", "dotceil"}
    for name in ("tap9", "im2col", "pair5", "dotceil"):
        assert out["rows"][name]["max_ulps"] == 0  # the wrappers ran their plain versions
    assert out["rows"]["conv_library"]["max_ulps_vs_tap9_plain"] <= 4
    with pytest.raises(ValueError, match="multiple of 16"):
        probe_path.main(device="cpu", b=1, h=8, w=32)
