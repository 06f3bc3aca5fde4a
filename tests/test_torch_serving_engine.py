"""The serving entry points of tgsr_tpu_torch's SRPipeline against tgsr_tpu
on the CPU: `sr_uint8`, `sr_arbitrary` (native and bucketed, on a
non-square LR that is no multiple of anything), `sr_batched`'s (m, b) plan
with and without a microbatch, and the memory planner's arithmetic.

Gates, those of tests/test_torch_pipeline.py: float32 SR rtol = 1e-3,
atol = 2e-4 (float reassociation); uint8 images within one level, in under
1 % of the values (a float within that error of a rounding boundary).
On the CPU the pipeline runs the forward eagerly (no CUDA graph) and plans
with CPU_MICROBATCH; the card's side is in tests/test_torch_kernels_cuda.py
and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from tgsr_tpu.engine.inference import SRPipeline as JSRPipeline
from tgsr_tpu_torch.checkpoints.from_jax import state_dicts_from_jax
from tgsr_tpu_torch.engine import inference
from tgsr_tpu_torch.engine.inference import SRPipeline, to_uint8
from tgsr_tpu_torch.utils import memory
from tests.torch_parity import SMALL, VOCAB, configs, inputs, jax_trees

torch.set_num_threads(1)
T = SMALL["WORDS_NUM"]


@pytest.fixture(scope="module")
def pipes():
    jcfg, tcfg = configs()
    trees = jax_trees(jcfg)
    return (JSRPipeline(jcfg, VOCAB, *trees),
            SRPipeline(tcfg, VOCAB, *state_dicts_from_jax(*trees), device="cpu"))


def assert_uint8_close(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 0.01


def test_sr_uint8_matches_jax(pipes):
    jpipe, tpipe = pipes
    lr, cap, lens = inputs(3, SMALL["BASE_SIZE"], T, [T, 2, 0], seed=21)
    got = tpipe.sr_uint8(lr, cap, lens)
    assert isinstance(got, np.ndarray) and got.shape == (3, 64, 64, 3)
    assert_uint8_close(got, jpipe.sr_uint8(lr, cap, lens))
    np.testing.assert_array_equal(got, to_uint8(tpipe(lr, cap, lens)["sr"]).numpy())
    assert not tpipe.graphs  # the CPU runs the forward eagerly


@pytest.mark.parametrize("bucket", [None, 4, 8])
def test_sr_arbitrary_matches_jax(pipes, bucket):
    """LR 5 x 7 -> SR 40 x 56; bucket 4 and 8 edge-pad it to 8 x 8."""
    jpipe, tpipe = pipes
    rng = np.random.default_rng(22)
    lr = rng.uniform(-1, 1, (1, 5, 7, 3)).astype(np.float32)
    _, cap, lens = inputs(1, 8, T, [4], seed=22)
    got = tpipe.sr_arbitrary(lr, cap, lens, bucket=bucket)
    assert got.shape == (1, 40, 56, 3)
    assert_uint8_close(got, jpipe.sr_arbitrary(lr, cap, lens, bucket=bucket))
    if bucket:
        padded = np.pad(lr, ((0, 0), (0, 3), (0, 1), (0, 0)), mode="edge")
        sr = tpipe(padded, cap, lens)["sr"][:, :40, :56]
        np.testing.assert_array_equal(got, to_uint8(sr).numpy())


def test_sr_arbitrary_takes_one_image(pipes):
    _, tpipe = pipes
    lr, cap, lens = inputs(2, 8, T, [2, 3])
    with pytest.raises(ValueError):
        tpipe.sr_arbitrary(lr, cap, lens)


def _plans(pipe, n, microbatch, as_torch):
    """The (m, b) shapes `sr_batched` hands `forward_scan` for N images."""
    seen = []

    def spy(lr, captions, cap_lens):
        m, b = lr.shape[:2]
        seen.append((m, b))
        out = np.zeros((m, b, 2, 2, 3), np.uint8)
        return torch.from_numpy(out) if as_torch else out

    pipe.forward_scan = spy
    try:
        pipe.sr_batched(np.zeros((n, 1, 1, 3), np.uint8), np.zeros((n, T), np.int32),
                        np.zeros(n, np.int32), microbatch=microbatch)
    finally:
        del pipe.forward_scan
    return seen


def test_sr_batched_plan_matches_jax(pipes):
    """The (m, b) plan for N = 1..300 at several microbatches, and with
    microbatch=None (the port's CPU_MICROBATCH, JAX given the same): b
    balanced to ceil(N / m) and rounded up to a multiple of 64."""
    jpipe, tpipe = pipes
    for mb in (None, 1, 2, 7, 64, 100, 128):
        for n in range(1, 301):
            got = _plans(tpipe, n, mb, as_torch=True)
            ref = _plans(jpipe, n, mb or inference.CPU_MICROBATCH, as_torch=False)
            assert got == ref == [SRPipeline.plan_batches(n, mb or inference.CPU_MICROBATCH)], (
                n, mb)
    assert SRPipeline.plan_batches(65, 64) == (2, 64)
    assert tpipe.plan_microbatch() == inference.CPU_MICROBATCH


def test_sr_batched_default_microbatch_matches_jax(pipes):
    """N = 70 with the default microbatch: two microbatches of 64, the tail
    padded by replicas; uint8 ingress and egress."""
    jpipe, tpipe = pipes
    lr, cap, lens = inputs(70, SMALL["BASE_SIZE"], T, np.arange(70) % (T + 1), seed=23)
    lr8 = np.round((lr + 1) * 127.5).astype(np.uint8)
    got = tpipe.sr_batched(lr8, cap, lens)
    assert_uint8_close(got, jpipe.sr_batched(lr8, cap, lens, microbatch=inference.CPU_MICROBATCH))
    with pytest.raises(ValueError):
        tpipe.sr_batched(lr8, cap, lens, microbatch=0)


def test_memory_fit_and_plan():
    """need(b) = fixed + per_image * b through two probes; the plan fits
    GRAPH_COPIES working sets and the other graphs' held bytes in the
    budget, in multiples of the quantum (powers of two below it)."""
    assert memory.fit({64: 1000 + 64 * 30, 128: 1000 + 128 * 30}) == (1000, 30)
    assert memory.fit({128: 5000, 64: 5000}) == (5000, 0)
    assert memory.GRAPH_COPIES == 2
    budget = 2 * (1000 + 30 * 700)  # room for 700 images twice over
    assert memory.max_microbatch(1000, 30, budget, 64) == 640
    assert memory.max_microbatch(1000, 30, budget, 1) == 700
    assert memory.max_microbatch(1000, 30, budget, 64, held_per_image=60) == 320  # 350
    assert memory.max_microbatch(1000, 30, 2 * (1000 + 30 * 50), 64) == 32  # 50, below a quantum
    assert memory.max_microbatch(1000, 30, 10 ** 9, 64) == memory.MAX_MICROBATCH
    assert memory.max_microbatch(1000, 0, budget, 64) == memory.MAX_MICROBATCH
    for fixed, per_image, budget in ((1000, 30, 2 * 1000), (3000, 0, 2 * 1000)):
        with pytest.raises(RuntimeError):
            memory.max_microbatch(fixed, per_image, budget, 64)
    calls = []

    def need(b):
        calls.append(b)
        return 4096 + 100 * b

    budget = 2 * (4096 + 100 * 1000)
    plan = memory.plan(need, budget, 64)
    assert calls == [64, 64 * memory.PROBE_SPAN] and plan.microbatch == 960
    assert (plan.fixed_bytes, plan.per_image_bytes, plan.held_per_image_bytes,
            plan.budget_bytes) == (4096, 100, 0, budget)
    assert plan.probes == {64: 4096 + 6400, 256: 4096 + 25600}
    assert memory.plan(need, budget, 64, held_per_image=200).microbatch == 448  # 500


@pytest.mark.parametrize("path, probes, budget, microbatch", [
    ("float32", {64: 12807307264, 256: 54395928576}, 64790219980, 128),
    ("bfloat16", {64: 5419040768, 256: 22552772608}, 73066630348, 320),
    ("int8", {64: 7472152576, 256: 30022828032}, 72613645516, 256),
    ("int8 f32", {64: 14279507968, 256: 57201917952}, 71075384524, 128),
])
def test_memory_plan_x16_from_card_probes(path, probes, budget, microbatch):
    """The x16 family's plans (configs/eval_faceSR_S16.yml, 512 px out) as
    chip_smoke.py read them on one H100 80GB HBM3 at 700 W: plan() given the
    bytes each probe reserved there and that run's budget gives the
    microbatch the card planned. The other graphs hold each their 32 px
    float32 LR, the token ids and lengths, and the 512 px uint8 SR."""
    graph_bytes = 32 * 32 * 3 * 4 + 19 * 8 + 512 * 512 * 3
    held = (inference.MAX_GRAPHS - 1) * graph_bytes
    calls = []

    def need(b):
        calls.append(b)
        (b1, n1), (b2, n2) = sorted(probes.items())
        return n1 + (n2 - n1) * (b - b1) // (b2 - b1)

    plan = memory.plan(need, budget, inference.MICROBATCH_QUANTUM, held)
    assert calls == [64, 64 * memory.PROBE_SPAN] and plan.probes == probes
    assert held == 11983080 and plan.fixed_bytes == 0
    assert plan.microbatch == microbatch, (path, plan)


def test_graph_batch_sizes():
    """On the card a microbatch of b replays the graph at graph_batch(b):
    the next power of two up to 64, then the next multiple of 64; the sizes
    1..MAX_MICROBATCH need 70 graphs, and every size a memory plan can
    return is a graph batch itself."""
    for b in range(1, memory.MAX_MICROBATCH + 1):
        g = SRPipeline.graph_batch(b)
        assert b <= g < 2 * b if b <= 64 else b <= g < b + 64, b
        assert (g & (g - 1) == 0) if b <= 64 else g % 64 == 0, b
    sizes = {SRPipeline.graph_batch(b) for b in range(1, memory.MAX_MICROBATCH + 1)}
    assert len(sizes) == 70
    for budget in range(2 * 1000 + 67, 2 * (1000 + 30 * 5000), 997):  # b = 1 and up
        b = memory.max_microbatch(1000, 30, budget, inference.MICROBATCH_QUANTUM, 7)
        assert SRPipeline.graph_batch(b) == b, b
