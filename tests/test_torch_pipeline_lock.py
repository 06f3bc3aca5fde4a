"""SRPipeline is safe to call from many threads: its one lock keeps a
second thread's forward out while another thread is inside forward_scan
(on the card, inside a graph's copy-in, replay and copy-out, or a capture),
shown on the CPU with a `_serve` that blocks until released; and many
threads calling at once get what each gets alone (equality)."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from tgsr_tpu_torch.checkpoints.from_jax import init_seeded
from tgsr_tpu_torch.config import Config, GanConfig, TextConfig, TreeConfig
from tgsr_tpu_torch.engine.inference import SRPipeline

torch.set_num_threads(1)
T, SIZE = 6, 8


@pytest.fixture(scope="module")
def pipe():
    cfg = Config(TREE=TreeConfig(4, SIZE), GAN=GanConfig(8, 10, 2), TEXT=TextConfig(32, T))
    return SRPipeline(cfg, 41, *init_seeded(cfg, 41, torch.Generator().manual_seed(0)),
                      device="cpu")


def _inputs(b, seed):
    rng = np.random.default_rng(seed)
    lr = rng.uniform(-1, 1, (b, SIZE, SIZE, 3)).astype(np.float32)
    lens = rng.integers(1, T + 1, b)
    cap = rng.integers(1, 41, (b, T))
    cap[np.arange(T)[None, :] >= lens[:, None]] = 0
    return lr, cap, lens


@pytest.mark.parametrize("second", ["sr_uint8", "sr_arbitrary", "sr_batched", "__call__"])
def test_second_thread_waits_for_forward_scan(pipe, second, monkeypatch):
    events = []
    entered, release = threading.Event(), threading.Event()
    # every entry point's forward is `pipe.serving` (engine/inference.py
    # ServingForward); its `pyramid` is what a second thread would run
    serve, forward = pipe._serve, pipe.serving.pyramid

    def blocking_serve(*args):
        name = threading.current_thread().name
        events.append((name, "serve"))
        if name == "first":
            entered.set()
            assert release.wait(60)
        out = serve(*args)
        events.append((name, "serve done"))
        return out

    def recording_forward(*args):
        events.append((threading.current_thread().name, "forward"))
        return forward(*args)

    monkeypatch.setattr(pipe, "_serve", blocking_serve)
    monkeypatch.setattr(pipe.serving, "pyramid", recording_forward)
    lr, cap, lens = _inputs(2, 0)
    one = _inputs(1, 1)
    calls = {"sr_uint8": lambda: pipe.sr_uint8(*one),
             "sr_arbitrary": lambda: pipe.sr_arbitrary(*one, bucket=16),
             "sr_batched": lambda: pipe.sr_batched((one[0][0:1] * 127.5 + 127.5)
                                                   .astype(np.uint8), *one[1:]),
             "__call__": lambda: pipe(*one)}
    first = threading.Thread(name="first", target=lambda: pipe.forward_scan(
        lr[None], cap[None], lens[None]))
    other = threading.Thread(name="second", target=calls[second])
    first.start()
    assert entered.wait(60)
    other.start()
    time.sleep(0.3)
    assert other.is_alive() and not [e for e in events if e[0] == "second"]
    release.set()
    first.join(60)
    other.join(60)
    assert not first.is_alive() and not other.is_alive()
    done = events.index(("first", "serve done"))
    assert [e for e in events[:done] if e[0] == "second"] == []
    assert ("second", "forward") in events[done:]


def test_many_threads_get_their_solo_results(pipe):
    """8 threads x 3 calls of sr_uint8 and sr_arbitrary on one pipeline,
    with a short switch interval: every result equals the same call alone."""
    jobs = [(k, i) for k in range(8) for i in range(3)]
    inputs = {j: _inputs(1 + j[1] % 2, 100 * j[0] + j[1]) for j in jobs}

    def call(j):
        lr, cap, lens = inputs[j]
        if j[0] % 2:
            return pipe.sr_arbitrary(lr[:1], cap[:1], lens[:1], bucket=None)
        return pipe.sr_uint8(lr, cap, lens)

    solo = {j: call(j) for j in jobs}
    got = {}

    def worker(k):
        for j in jobs:
            if j[0] == k:
                got[j] = call(j)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    for j in jobs:
        np.testing.assert_array_equal(got[j], solo[j], err_msg=str(j))
