"""The port's int8 bookkeeping (tgsr_tpu_torch/engine/quant.py, the conv-site
table of checkpoints/from_jax.py, calibration) against tgsr_tpu's.

Quantizers: bit-exact (int8 values and float32 steps equal) on float32 and
bfloat16 inputs, .5 ties and clipping included. Key table, fingerprint and
`check_scales`: exact. Calibration: the same key set, values within
rtol 1e-4 in float32 (convolutions summed in another order) and 2e-2 in
bfloat16 (activations rounded at other places; one bfloat16 step is 2^-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgsr_tpu.engine import quant as jq
from tgsr_tpu.engine.inference import SRPipeline as JSRPipeline
from tgsr_tpu_torch.checkpoints.from_jax import conv_sites, state_dicts_from_jax
from tgsr_tpu_torch.engine import quant as tq
from tgsr_tpu_torch.engine.inference import SRPipeline
from tests.torch_parity import SMALL, VOCAB, configs, inputs, jax_trees

torch.set_num_threads(1)
T = SMALL["WORDS_NUM"]


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs()
    trees = jax_trees(jcfg)
    sds = state_dicts_from_jax(*trees)
    return dict(jcfg=jcfg, tcfg=tcfg, trees=trees, sds=sds,
                port=SRPipeline(tcfg, VOCAB, *sds, device="cpu"))


def _ties_and_clips(rng, shape):
    x = rng.normal(0, 1, shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[:8] = [0.5, 1.5, 2.5, -0.5, -1.5, 126.5, -126.5, 200.0]  # in steps of 1
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_act_bit_exact(dtype):
    rng = np.random.default_rng(0)
    scale = 3.0
    step = np.float32(scale / 127.0)
    x = _ties_and_clips(rng, (4, 5, 6, 7)) * step  # ties land on x / step = k + .5
    x[0, 0, 0, :3] = [10 * scale, -10 * scale, 0.0]  # clipped both ways
    xj = jnp.asarray(x).astype(dtype)
    qj, sj = jq.quantize_act(xj, scale)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    qt, st = tq.quantize_act(xt, scale)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert float(st) == float(sj)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert np.asarray(qj).max() == 127 and np.asarray(qj).min() == -127


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kernel_bit_exact(dtype):
    rng = np.random.default_rng(1)
    w = rng.normal(0, 0.2, (3, 3, 16, 24)).astype(np.float32)  # HWIO
    w[0, 0, 0, :4] = [1.0, -1.0, 0.5, 0.0]
    w[..., 5] = 0.0  # an all-zero channel: step 1e-12 / 127
    step = np.abs(w).max(axis=(0, 1, 2)) / 127.0
    w[1, 1, 1, :] = 0.5 * step  # exact ties at +-0.5 steps
    wj = jnp.asarray(w).astype(dtype)
    qj, sj = jq.quantize_kernel(wj)
    wt = torch.from_numpy(np.array(wj.astype(jnp.float32))).to(getattr(torch, dtype))
    qt, st = tq.quantize_kernel(wt.permute(3, 2, 0, 1))  # OIHW
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(qt.permute(2, 3, 1, 0).numpy(), np.asarray(qj))


def test_site_sets_match_jax():
    assert tq.QMAX == jq.QMAX
    assert tq.SPLIT_GLU_INT8_CONSUMERS == jq.SPLIT_GLU_INT8_CONSUMERS
    assert tq.HEAD_FEEDING_UPBLOCKS == jq.HEAD_FEEDING_UPBLOCKS
    assert tq.SPLIT_RES_GLU_SITES == jq.SPLIT_RES_GLU_SITES
    assert tq.FUSED_UP_OUT_CONSUMER == jq.FUSED_UP_OUT_CONSUMER
    assert tq.SCALES_META_KEY == jq.SCALES_META_KEY
    for scales in ({"img_net1/conv": 1.0, "h_net1/im2f_conv": 2.0}, {"h_net1/im2f_conv": 2.0}):
        assert tq.heads_quantized(scales) == jq.heads_quantized(scales)
        assert tq.effective_split_glu(scales) == jq.effective_split_glu(scales)
    a, b = {"x": 1.0, "y": 3.0}, {"y": 2.0, "z": 5.0}
    assert tq.merge_scales(a, b) == jq.merge_scales(a, b)
    shipped = tq.face_s8_scales()
    assert tq.drop_head_scales(shipped) == jq.drop_head_scales(jq.face_s8_scales())
    assert tq.split_scales_meta(shipped) == jq.split_scales_meta(jq.face_s8_scales())
    assert tq.face_s8_scales(heads=False) == jq.face_s8_scales(heads=False)


def test_shipped_scales_copy_is_byte_identical():
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "tgsr_tpu/checkpoints/face_s8_int8_scales.json"), "rb") as f:
        a = f.read()
    with open(os.path.join(root, "tgsr_tpu_torch/checkpoints/face_s8_int8_scales.json"), "rb") as f:
        assert f.read() == a


def test_key_table_covers_conv_kernel_sites(setup):
    """Every conv_kernel_sites key of both JAX trees maps to a port conv,
    whose weight is the JAX kernel transposed HWIO -> OIHW; also at the face
    S8 geometry (R_NUM 2, 6 HF ResBlocks), against the shipped scales' keys."""
    port = setup["port"]
    tables = conv_sites(port.netg, port.netgh)
    for group, tree in zip(("netg", "netgh"), setup["trees"][1:]):
        sites = jq.conv_kernel_sites(tree["params"])
        assert set(tables[group]) == set(sites)
        module = port.netg if group == "netg" else port.netgh
        for key, path in tables[group].items():
            w = module.get_submodule(path).weight.detach()
            np.testing.assert_array_equal(w.permute(2, 3, 1, 0).numpy(),
                                          np.asarray(sites[key]), err_msg=key)
    shipped = tq.face_s8_scales()
    assert set(tables["netg"]) == set(shipped["netg"])
    assert set(tables["netgh"]) == set(shipped["netgh"])


def test_weights_fingerprint_matches_jax(setup):
    port = setup["port"]
    want = jq.weights_fingerprint(setup["trees"][1], setup["trees"][2])
    assert tq.weights_fingerprint(port.netg, port.netgh) == want


def test_check_scales_refuses(setup):
    port, trees = setup["port"], setup["trees"]
    shipped, meta = tq.split_scales_meta(tq.face_s8_scales())
    # the shipped face scales carry the face_S8 fingerprint, not these weights';
    # at this narrow geometry their keys match (same tree), so the fingerprint
    # is what refuses them, in both packages
    for check, args in ((tq.check_scales, (port.netg, port.netgh)),
                        (jq.check_scales, (trees[1], trees[2]))):
        with pytest.raises(ValueError, match="fingerprint mismatch"):
            check(shipped, *args, meta=meta)
        with pytest.raises(ValueError, match="match no conv"):
            check({"netg": {"h_net1/im2f_conv": 1.0, "h_net9/conv": 1.0}}, *args)
        with pytest.raises(ValueError, match="matches any conv"):
            check({"netgh": {"nope/conv": 1.0}}, *args)
        with pytest.raises(ValueError, match="unknown scales group"):
            check({"text": {"x": 1.0}}, *args)
        check(shipped, *args)  # without '_meta': keys alone
    good = tq.weights_fingerprint(port.netg, port.netgh)
    tq.check_scales(shipped, port.netg, port.netgh, meta={"weights_fingerprint": good})
    _, tcfg = configs()
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        SRPipeline(tcfg, VOCAB, *setup["sds"], device="cpu", compute_dtype=torch.bfloat16,
                   quant_scales=tq.face_s8_scales())


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_calibrate_quant_matches_jax(setup, dtype, rtol):
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    lr, cap, lens = inputs(3, jcfg.TREE.BASE_SIZE, T, [T, 2, 0], seed=7)
    jpipe = JSRPipeline(jcfg, VOCAB, *setup["trees"], compute_dtype=getattr(jnp, dtype))
    ref = jpipe.calibrate_quant(lr, cap, lens)
    port = SRPipeline(tcfg, VOCAB, *setup["sds"], device="cpu",
                      compute_dtype=getattr(torch, dtype))
    got = port.calibrate_quant(lr, cap, lens)
    assert set(got) == set(ref) == {"netg", "netgh"}
    for group in ref:
        assert set(got[group]) == set(ref[group]) == set(jq.conv_kernel_sites(
            setup["trees"][1 if group == "netg" else 2]["params"]))
        for k, v in ref[group].items():
            assert got[group][k] == pytest.approx(v, rel=rtol), f"{group} {k}"
    assert jax.default_backend() == "cpu"
