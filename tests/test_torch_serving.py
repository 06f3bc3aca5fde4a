"""tgsr_tpu_torch's BatchingServer on a CPU pipeline, by the six cases of
tests/test_serving.py (request coalescing into planned sizes, parity with
the direct `sr_uint8` path, concurrent submitters, rejected
requests and close, shape pinning, a cancelled rider), plus warmup, which
runs every planned size on the collector thread (the one thread that owns
the card), and a failing warmup, which raises to its caller and leaves the
collector alive.

A served row is held to its direct result within one uint8 level, where
JAX's test asks for equality: PyTorch's CPU convolutions may sum in another
order at another batch size (B = 2 against B = 12 moves a value by one
level here), the row gate of tests/test_torch_pipeline.py (atol 1e-5 on
the float SR) seen through the rounding to uint8.
"""

import threading

import numpy as np
import pytest
import torch

from tgsr_tpu_torch.checkpoints.from_jax import init_seeded
from tgsr_tpu_torch.config import Config, GanConfig, TextConfig, TreeConfig
from tgsr_tpu_torch.engine.inference import SRPipeline
from tgsr_tpu_torch.engine.serving import BatchingServer

torch.set_num_threads(1)
T, SIZE, OUT = 6, 8, 64  # caption slots, LR and SR sizes of the narrow x8 tree


@pytest.fixture(scope="module")
def small_pipe():
    cfg = Config(TREE=TreeConfig(4, SIZE), GAN=GanConfig(8, 10, 2), TEXT=TextConfig(32, T))
    return SRPipeline(cfg, 41, *init_seeded(cfg, 41, torch.Generator().manual_seed(0)),
                      device="cpu")


def _requests(n, seed=0):
    rng = np.random.default_rng(seed)
    lrs = rng.normal(0, 0.3, (n, SIZE, SIZE, 3)).astype(np.float32)
    caps = np.zeros((n, T), np.int32)
    lens = rng.integers(2, T + 1, n).astype(np.int32)
    for i in range(n):
        caps[i, : lens[i]] = rng.integers(1, 41, lens[i])
    return lrs, caps, lens


def test_serving_matches_direct_path(small_pipe):
    lrs, caps, lens = _requests(10)
    with BatchingServer(small_pipe, max_batch=4, max_delay_ms=10) as srv:
        futs = [srv.submit(lrs[i], caps[i], lens[i]) for i in range(10)]
        outs = [f.result(timeout=120) for f in futs]
    st = srv.stats
    assert st["requests"] == 10
    assert set(st["batch_hist"]) <= {1, 2, 4}
    assert srv.latency_percentiles()["p50_ms"] > 0
    direct = small_pipe.sr_uint8(lrs, caps, lens)
    for i, o in enumerate(outs):
        assert o.shape == (OUT, OUT, 3) and o.dtype == np.uint8
        diff = np.abs(o.astype(int) - direct[i].astype(int)).max()
        assert diff <= 1, f"row {i}: {diff}"


def test_serving_concurrent_submitters(small_pipe):
    lrs, caps, lens = _requests(12, seed=1)
    results = {}
    with BatchingServer(small_pipe, max_batch=8, max_delay_ms=5) as srv:
        def worker(i):
            results[i] = srv.submit(lrs[i], caps[i], lens[i]).result(timeout=120)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    assert sorted(results) == list(range(12))
    assert srv.stats_snapshot()["requests"] == 12
    for i in range(12):
        one = small_pipe.sr_uint8(lrs[i:i + 1], caps[i:i + 1], lens[i:i + 1])[0]
        assert np.abs(results[i].astype(int) - one.astype(int)).max() <= 1


def test_serving_rejects_bad_requests_and_close(small_pipe):
    srv = BatchingServer(small_pipe, max_batch=2, max_delay_ms=1)
    bad_lr = srv.submit(np.zeros((SIZE, SIZE)), np.zeros(T, np.int32), 2)
    with pytest.raises(ValueError):
        bad_lr.result(timeout=5)
    bad_cap = srv.submit(np.zeros((SIZE, SIZE, 3), np.float32), np.zeros(T + 1, np.int32), 2)
    with pytest.raises(ValueError):
        bad_cap.result(timeout=5)
    # requests already queued at close() time are still served
    lrs, caps, lens = _requests(3, seed=2)
    futs = [srv.submit(lrs[i], caps[i], lens[i]) for i in range(3)]
    srv.close()
    for f in futs:
        assert f.result(timeout=120).shape == (OUT, OUT, 3)
    with pytest.raises(RuntimeError):
        srv.submit(lrs[0], caps[0], lens[0]).result(timeout=5)
    with pytest.raises(RuntimeError):
        srv.warmup(lr_shape=(SIZE, SIZE, 3))


def test_planned_sizes_validation(small_pipe):
    with pytest.raises(ValueError):
        BatchingServer(small_pipe, max_batch=8, planned_sizes=[2, 4])
    with pytest.raises(ValueError):
        BatchingServer(small_pipe, max_batch=0)


def test_serving_shape_pinning_keeps_collector_alive(small_pipe):
    """A mismatched-lr request is rejected at submit, and later same-shape
    requests still serve."""
    lrs, caps, lens = _requests(4)
    with BatchingServer(small_pipe, max_batch=4, max_delay_ms=5) as srv:
        ok0 = srv.submit(lrs[0], caps[0], lens[0])
        bad = srv.submit(np.zeros((2 * SIZE, 2 * SIZE, 3), np.float32), caps[1], lens[1])
        with pytest.raises(ValueError):
            bad.result(timeout=5)
        ok1 = srv.submit(lrs[1], caps[1], lens[1])
        assert ok0.result(timeout=120).shape == (OUT, OUT, 3)
        assert ok1.result(timeout=120).shape == (OUT, OUT, 3)


def test_serving_cancelled_future_does_not_kill_batch(small_pipe):
    """A rider cancelled while pending neither wedges the collector nor
    counts as processed; the live riders resolve normally."""
    lrs, caps, lens = _requests(3, seed=3)
    with BatchingServer(small_pipe, max_batch=4, max_delay_ms=50) as srv:
        f0 = srv.submit(lrs[0], caps[0], lens[0])
        f1 = srv.submit(lrs[1], caps[1], lens[1])
        f1.cancel()
        f2 = srv.submit(lrs[2], caps[2], lens[2])
        assert f0.result(timeout=120).shape == (OUT, OUT, 3)
        assert f2.result(timeout=120).shape == (OUT, OUT, 3)
        assert f1.cancelled()
        assert not f0.cancel()
    snap = srv.stats_snapshot()
    assert snap["requests"] == 2 and snap["batches"] >= 1


class _Recorder:
    """A pipeline stand-in that records which thread runs each batch size."""

    def __init__(self, pipe, fail=False):
        self.cfg, self.pipe, self.fail = pipe.cfg, pipe, fail
        self.calls = []

    def sr_uint8(self, lr, captions, cap_lens):
        self.calls.append((lr.shape[0], threading.current_thread().name))
        if self.fail:
            raise RuntimeError("capture failed")
        return self.pipe.sr_uint8(lr, captions, cap_lens)


def test_warmup_runs_every_planned_size_on_the_collector(small_pipe):
    rec = _Recorder(small_pipe)
    with BatchingServer(rec, max_batch=8, max_delay_ms=5) as srv:
        with pytest.raises(ValueError):
            srv.warmup()  # no lr shape known yet
        srv.warmup(lr_shape=(SIZE, SIZE, 3))
        assert rec.calls == [(b, "tgsr-batching-server") for b in (1, 2, 4, 8)]
        lrs, caps, lens = _requests(2, seed=4)
        futs = [srv.submit(lrs[i], caps[i], lens[i]) for i in range(2)]
        assert all(f.result(timeout=120).shape == (OUT, OUT, 3) for f in futs)
    assert all(name == "tgsr-batching-server" for _, name in rec.calls)


def test_failed_warmup_raises_and_the_collector_lives(small_pipe):
    rec = _Recorder(small_pipe, fail=True)
    with BatchingServer(rec, max_batch=2, max_delay_ms=1, lr_shape=(SIZE, SIZE, 3)) as srv:
        with pytest.raises(RuntimeError, match="capture failed"):
            srv.warmup()
        rec.fail = False
        lrs, caps, lens = _requests(1, seed=5)
        assert srv.submit(lrs[0], caps[0], lens[0]).result(timeout=120).shape == (OUT, OUT, 3)
