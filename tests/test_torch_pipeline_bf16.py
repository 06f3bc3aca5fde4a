"""bfloat16 serving of tgsr_tpu_torch against tgsr_tpu on the CPU.

One seeded tgsr_tpu init (BN statistics perturbed, blend a = 0.3) is
carried across with `state_dicts_from_jax`; inputs are numpy from a seed.
Both pipelines run with compute_dtype bfloat16: the text encoder in float32,
everything else cast (tgsr_tpu/engine/inference.py `_cast_floats`). They
round at other places (the port's up-head sites sum in float32 and round
the GLU once, JAX's XLA chain rounds every step), so they are held by PSNR
on [-1, 1] with peak 2, not elementwise: >= 50 dB against JAX bfloat16 and
against the port's own float32 (JAX's bfloat16 reads 65 dB against its
float32 here). uint8 outputs: PSNR >= 50 dB with peak 255, and no value
more than 2 levels apart (one bfloat16 step of sr near 1 is 2^-7, about one
level, and a value that lands near a rounding boundary flips by one more).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgsr_tpu.engine.inference import SRPipeline as JSRPipeline
from tgsr_tpu_torch.checkpoints.from_jax import state_dicts_from_jax
from tgsr_tpu_torch.engine.inference import SRPipeline, to_uint8
from tests.torch_parity import SMALL, VOCAB, configs, inputs, jax_trees

torch.set_num_threads(1)
T = SMALL["WORDS_NUM"]
MIN_PSNR = 50.0


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs()
    trees = jax_trees(jcfg)
    sds = state_dicts_from_jax(*trees)
    return dict(
        jcfg=jcfg, trees=trees,
        jax_bf16=JSRPipeline(jcfg, VOCAB, *trees, compute_dtype=jnp.bfloat16),
        port_bf16=SRPipeline(tcfg, VOCAB, *sds, device="cpu",
                             compute_dtype=torch.bfloat16, return_attn=True),
        port_f32=SRPipeline(tcfg, VOCAB, *sds, device="cpu", return_attn=True))


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 10 * np.log10(4.0 / mse)


def test_call_matches_jax_bf16(setup):
    """sr and every pyramid scale, mixed caption lengths incl. an empty one."""
    lr, cap, lens = inputs(3, setup["jcfg"].TREE.BASE_SIZE, T, [T, 3, 0], seed=3)
    ref = setup["jax_bf16"](lr, cap, lens)
    got = setup["port_bf16"](lr, cap, lens)
    own = setup["port_f32"](lr, cap, lens)
    assert tuple(got["sr"].shape) == (3, 64, 64, 3)
    for i, (p, pr, pf) in enumerate(zip(got["pyramid"], ref["pyramid"], own["pyramid"])):
        assert _psnr(p.numpy(), np.asarray(pr)) >= MIN_PSNR, f"scale {i} vs JAX bf16"
        assert _psnr(p.numpy(), pf.numpy()) >= MIN_PSNR, f"scale {i} vs port f32"
    assert _psnr(got["sr"].numpy(), np.asarray(ref["sr"])) >= MIN_PSNR


def test_outputs_f32_and_casts(setup):
    """sr, the pyramid and attn come back float32; the text encoder stays
    float32 (its outputs are cast after it); every floating-point parameter
    and buffer of both generators is bfloat16, BN statistics and `a` too."""
    pipe = setup["port_bf16"]
    lr, cap, lens = inputs(2, setup["jcfg"].TREE.BASE_SIZE, T, [T, 2], seed=4)
    out = pipe(lr, cap, lens)
    assert all(t.dtype == torch.float32
               for t in [out["sr"], *out["pyramid"], *out["attn"]])
    assert [tuple(a.shape) for a in out["attn"]] == [(2, T, 8, 8), (2, T, 16, 16),
                                                      (2, T, 32, 32)]
    words, sent = pipe.text_encoder(torch.from_numpy(cap).long(),
                                    torch.from_numpy(lens).long())
    assert words.dtype == sent.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in pipe.text_encoder.parameters())
    for module in (pipe.netg, pipe.netgh):
        for name, t in [*module.named_parameters(), *module.named_buffers()]:
            want = torch.bfloat16 if t.is_floating_point() else torch.int64
            assert t.dtype == want, name
    assert pipe.netgh.a.item() == pytest.approx(0.3, abs=2 ** -9)


def _assert_uint8_close(got, ref):
    diff = got.astype(np.float64) - ref.astype(np.float64)
    assert np.abs(diff).max() <= 2, np.abs(diff).max()
    assert 10 * np.log10(255 ** 2 / np.mean(diff ** 2)) >= MIN_PSNR


def test_sr_batched_and_scan_match_jax_bf16(setup):
    """N = 5 at microbatch 2 (three microbatches, the tail padded by one
    replica), uint8 in and out; forward_scan gives the same rows, and the
    float32 egress of __call__ rounds to the same uint8."""
    lr, cap, lens = inputs(5, setup["jcfg"].TREE.BASE_SIZE, T, [T, 3, 0, 1, 5], seed=5)
    lr8 = np.round((lr + 1) * 127.5).astype(np.uint8)
    ref = setup["jax_bf16"].sr_batched(lr8, cap, lens, microbatch=2)
    pipe = setup["port_bf16"]
    got = pipe.sr_batched(lr8, cap, lens, microbatch=2)
    assert got.shape == ref.shape == (5, 64, 64, 3) and got.dtype == np.uint8
    _assert_uint8_close(got, ref)
    scan = pipe.forward_scan(lr8[:4].reshape(2, 2, *lr8.shape[1:]),
                             cap[:4].reshape(2, 2, T), lens[:4].reshape(2, 2))
    assert scan.dtype == torch.uint8
    np.testing.assert_array_equal(scan.reshape(4, 64, 64, 3).numpy(), got[:4])
    direct = to_uint8(pipe(lr8[:2].astype(np.float32) / 127.5 - 1.0, cap[:2],
                           lens[:2])["sr"]).numpy()
    np.testing.assert_array_equal(direct, got[:2])


def test_other_compute_dtypes_raise(setup):
    _, tcfg = configs()
    sds = state_dicts_from_jax(*setup["trees"])
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="compute_dtype"):
            SRPipeline(tcfg, VOCAB, *sds, device="cpu", compute_dtype=dtype)
