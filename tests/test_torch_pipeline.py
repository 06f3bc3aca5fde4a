"""The x8 serving forward of tgsr_tpu_torch against tgsr_tpu on the CPU, f32.

One seeded tgsr_tpu init (BN statistics perturbed, blend a = 0.3) is
carried across with `state_dicts_from_jax`; inputs are numpy from a seed.
Pyramid gate rtol = 1e-3, atol = 2e-4, the precedent of
tests/test_generator_parity.py: ~25 float32 conv layers and three attention
stages summed in another order. uint8 outputs may differ by one level where
a float lands within that reassociation error of a rounding boundary.
"""

import numpy as np
import pytest
import torch

from tgsr_tpu.engine.inference import SRPipeline as JSRPipeline
from tgsr_tpu.models.generator import GSRNetLow as JGSRNetLow
from tgsr_tpu.models.generator_hf import NetGHighWeight as JNetGHighWeight
from tgsr_tpu_torch.checkpoints.from_jax import state_dicts_from_jax
from tgsr_tpu_torch.engine.inference import SRPipeline, resolve_device, to_uint8
from tgsr_tpu_torch.models.generator import GSRNetLow
from tgsr_tpu_torch.models.generator_hf import NetGHighWeight
from tests.torch_parity import SMALL, VOCAB, configs, inputs, jax_trees

torch.set_num_threads(1)
PYR = dict(rtol=1e-3, atol=2e-4)
ATT = dict(rtol=1e-3, atol=1e-5)
T = SMALL["WORDS_NUM"]
LENS = [T, 3]


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs()
    trees = jax_trees(jcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, trees=trees, sds=state_dicts_from_jax(*trees))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def test_a_crosses_over(setup):
    assert setup["sds"][3] == pytest.approx(0.3)


def test_gsrnet_low_matches_jax(setup):
    jcfg, (_, netg_vars, _) = setup["jcfg"], setup["trees"]
    rng = np.random.default_rng(1)
    lr, _, _ = inputs(2, jcfg.TREE.BASE_SIZE, T, LENS)
    E = jcfg.TEXT.EMBEDDING_DIM
    words = rng.normal(size=(2, T, E)).astype(np.float32)
    sent = rng.normal(size=(2, E)).astype(np.float32)
    mask = np.arange(T)[None, :] >= np.asarray(LENS)[:, None]
    fake_r, att_r, mu_r, logvar_r = JGSRNetLow(
        ngf=jcfg.GAN.GF_DIM, c_dim=jcfg.GAN.CONDITION_DIM, n_stages=3).apply(
        netg_vars, lr, sent, words, mask)

    m = GSRNetLow(jcfg.GAN.GF_DIM, E, jcfg.GAN.CONDITION_DIM, 3).eval()
    m.load_state_dict(setup["sds"][1], strict=True)
    with torch.no_grad():
        fake, att, mu, logvar = m(_nchw(lr), torch.from_numpy(sent),
                                  torch.from_numpy(words), torch.from_numpy(mask),
                                  need_attn=True)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_r), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(logvar_r), rtol=1e-4, atol=1e-4)
    for i, (f, fr) in enumerate(zip(fake, fake_r)):
        np.testing.assert_allclose(_nhwc(f), np.asarray(fr), **PYR, err_msg=f"stage {i}")
    for i, (a, ar) in enumerate(zip(att, att_r)):
        np.testing.assert_allclose(a.numpy(), np.asarray(ar), **ATT, err_msg=f"attn {i}")


def test_netgh_weight_matches_jax(setup):
    jcfg, (_, _, netgh_vars) = setup["jcfg"], setup["trees"]
    rng = np.random.default_rng(2)
    lr, _, _ = inputs(2, jcfg.TREE.BASE_SIZE, T, LENS)
    srb = [rng.uniform(-1, 1, (2, s, s, 3)).astype(np.float32)
           for s in jcfg.pyramid_sizes()]
    ims_r, _, _ = JNetGHighWeight(ngf=jcfg.GAN.GF_DIM,
                                  sizes=tuple(jcfg.pyramid_sizes())).apply(
        netgh_vars, lr, srb, lr)

    m = NetGHighWeight(jcfg.GAN.GF_DIM).eval()
    m.load_state_dict(setup["sds"][2], strict=True)
    m.a.fill_(setup["sds"][3])
    with torch.no_grad():
        ims = m(_nchw(lr), [_nchw(s) for s in srb])
    for i, (f, fr) in enumerate(zip(ims, ims_r)):
        np.testing.assert_allclose(_nhwc(f), np.asarray(fr), **PYR, err_msg=f"scale {i}")


def _pipes(setup, **kw):
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    jpipe = JSRPipeline(jcfg, VOCAB, *setup["trees"], **kw)
    tpipe = SRPipeline(tcfg, VOCAB, *setup["sds"], device="cpu", **kw)
    return jpipe, tpipe


def test_pipeline_call_matches_jax(setup):
    jpipe, tpipe = _pipes(setup, return_attn=True)
    lr, cap, lens = inputs(2, setup["jcfg"].TREE.BASE_SIZE, T, LENS, seed=3)
    ref, got = jpipe(lr, cap, lens), tpipe(lr, cap, lens)
    assert tuple(got["sr"].shape) == (2, 64, 64, 3)
    for i, (p, pr) in enumerate(zip(got["pyramid"], ref["pyramid"])):
        np.testing.assert_allclose(p.numpy(), np.asarray(pr), **PYR, err_msg=f"scale {i}")
    np.testing.assert_allclose(got["sr"].numpy(), np.asarray(ref["sr"]), **PYR)
    for i, (a, ar) in enumerate(zip(got["attn"], ref["attn"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(ar), **ATT, err_msg=f"attn {i}")


def test_pipeline_row_equals_single(setup):
    """Row 0 of a mixed-length batch equals its B = 1 result."""
    _, tpipe = _pipes(setup)
    lr, cap, lens = inputs(2, setup["jcfg"].TREE.BASE_SIZE, T, [2, T], seed=4)
    sr2 = tpipe(lr, cap, lens)["sr"].numpy()
    sr1 = tpipe(lr[:1], cap[:1], lens[:1])["sr"].numpy()
    np.testing.assert_allclose(sr2[:1], sr1, rtol=0, atol=1e-5)


def _assert_uint8_close(got, ref):
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 0.01


@pytest.mark.parametrize("ingress", ["uint8", "float"])
def test_sr_batched_matches_jax(setup, ingress):
    """N = 5 at microbatch 2: three microbatches, the tail padded by one
    replica; uint8 or float ingress, uint8 egress."""
    jpipe, tpipe = _pipes(setup)
    lr, cap, lens = inputs(5, setup["jcfg"].TREE.BASE_SIZE, T, [T, 3, 0, 1, 5], seed=5)
    if ingress == "uint8":
        lr = np.round((lr + 1) * 127.5).astype(np.uint8)
    ref = jpipe.sr_batched(lr, cap, lens, microbatch=2)
    got = tpipe.sr_batched(lr, cap, lens, microbatch=2)
    assert got.shape == ref.shape == (5, 64, 64, 3) and got.dtype == np.uint8
    _assert_uint8_close(got, ref)
    scan = tpipe.forward_scan(lr[:4].reshape(2, 2, *lr.shape[1:]),
                              cap[:4].reshape(2, 2, T), lens[:4].reshape(2, 2))
    _assert_uint8_close(scan.reshape(4, 64, 64, 3).numpy(), got[:4])
    if ingress == "float":
        direct = to_uint8(tpipe(lr, cap, lens)["sr"]).numpy()
        _assert_uint8_close(got, direct)


def test_to_uint8_matches_jax_egress():
    """round(clip((sr + 1) * 127.5, 0, 255)) in float32, half to even, as the
    JAX forward_scan egress."""
    import jax.numpy as jnp

    sr = np.linspace(-1.2, 1.2, 20001, dtype=np.float32)
    ref = np.asarray(jnp.round(jnp.clip((jnp.asarray(sr) + 1.0) * 127.5, 0, 255))
                     .astype(jnp.uint8))
    np.testing.assert_array_equal(to_uint8(torch.from_numpy(sr)).numpy(), ref)


def test_entry_points_need_a_card_unless_asked():
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("switches", [True, False])
def test_float32_pipeline_on_the_cpu_leaves_tf32(setup, monkeypatch, capsys, switches):
    """A float32 pipeline turns TF32 off for the process only when it is
    built on the card (tests/test_torch_kernels_cuda.py
    test_float32_pipeline_turns_tf32_off): on the CPU, where there is no
    TF32, building one touches neither switch, whichever way they stand,
    and logs nothing about them."""
    from tgsr_tpu_torch.engine.precision import FLOAT32_MATH_NOTE

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", switches)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", switches)
    pipe = SRPipeline(setup["tcfg"], VOCAB, *setup["sds"], device="cpu")
    assert not pipe.pins_float32_math
    assert FLOAT32_MATH_NOTE not in capsys.readouterr().out
    assert torch.backends.cudnn.allow_tf32 is switches
    assert torch.backends.cuda.matmul.allow_tf32 is switches
