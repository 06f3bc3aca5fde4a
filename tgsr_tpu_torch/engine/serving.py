"""Request-level micro-batching server for SR serving (counterpart of
tgsr_tpu/engine/serving.py `BatchingServer`, with its API, stats and
latency percentiles).

    server = BatchingServer(pipe, max_batch=64, max_delay_ms=5)
    server.warmup(lr_shape=(32, 32, 3))       # one captured graph per size
    fut = server.submit(lr, caption, cap_len)  # thread-safe, any thread
    sr = fut.result()                          # uint8 [H, W, 3]

- Planned shapes: a batch is padded up to the next planned size (powers of
  two up to max_batch by default), and the pipeline keeps one captured CUDA
  graph per size (`SRPipeline.sr_uint8` replays the graph at
  `graph_batch(B)`, B itself for these sizes up to 64), so a handful of
  graphs serve every request count.
- One collector thread owns the card: every pipeline call, `warmup`'s
  captures included, runs on it, so no two calls race on the card, graphs
  replay one at a time (which their shared memory pool needs), and device
  order is completion order.
- max_delay_ms bounds how long the first request of a batch waits for
  co-riders; under load batches fill to max_batch and the timer never
  fires, so throughput converges to the batched pipeline's.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np


class _Task(NamedTuple):
    """Work that must run on the collector thread (warmup's captures)."""
    fn: Callable[[], None]
    fut: Future


class BatchingServer:
    def __init__(self, pipeline, max_batch: int = 64,
                 max_delay_ms: float = 5.0,
                 planned_sizes: Optional[Sequence[int]] = None,
                 lr_shape: Optional[Sequence[int]] = None):
        """`pipeline`: an SRPipeline. `planned_sizes` defaults to the powers
        of two up to max_batch. `lr_shape`: expected [h, w, 3] of every
        request; defaults to the first request's shape (one batch must be
        stackable: mismatched requests are rejected at submit)."""
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.pipeline = pipeline
        self.max_batch = int(max_batch)
        self.max_delay = float(max_delay_ms) / 1e3
        if planned_sizes is None:
            planned_sizes = []
            b = 1
            while b < self.max_batch:
                planned_sizes.append(b)
                b *= 2
            planned_sizes.append(self.max_batch)
        self.planned_sizes = sorted(set(int(b) for b in planned_sizes))
        if self.planned_sizes[-1] != self.max_batch:
            raise ValueError("planned_sizes must include max_batch")
        self._T = pipeline.cfg.TEXT.WORDS_NUM
        self._lr_shape = tuple(lr_shape) if lr_shape else None
        self._queue: "queue.Queue" = queue.Queue()
        self._closed = False
        self._lock = threading.Lock()
        # guards stats against concurrent readers while the collector mutates
        self._stats_lock = threading.Lock()
        self.stats: Dict[str, object] = {
            "requests": 0, "batches": 0, "batch_hist": {},
            "latency_ms": [],  # bounded, the most recent 4096
        }
        self._thread = threading.Thread(target=self._collector, daemon=True,
                                        name="tgsr-batching-server")
        self._thread.start()

    # ---- client API -----------------------------------------------------

    def submit(self, lr: np.ndarray, caption: np.ndarray, cap_len: int) -> Future:
        """Enqueue one request. lr [h, w, 3] float32 in [-1, 1]; caption
        [T] int32 (0-padded); cap_len its true length. Returns a Future
        resolving to the SR image as uint8 [H, W, 3]."""
        fut: Future = Future()
        lr = np.asarray(lr, np.float32)
        caption = np.asarray(caption, np.int32)
        if lr.ndim != 3 or lr.shape[-1] != 3:
            fut.set_exception(ValueError(f"lr must be [h,w,3], {lr.shape}"))
            return fut
        if caption.shape != (self._T,):
            fut.set_exception(ValueError(f"caption must be [{self._T}], got {caption.shape}"))
            return fut
        # the enqueue is atomic with the closed check and the shape pinning:
        # a put after close() would strand the future (the collector has
        # drained), and a mismatched lr shape would fail the whole batch
        with self._lock:
            if self._closed:
                fut.set_exception(RuntimeError("server closed"))
                return fut
            if self._lr_shape is None:
                self._lr_shape = lr.shape  # pinned by the first request
            if lr.shape != self._lr_shape:
                fut.set_exception(ValueError(
                    f"lr shape {lr.shape} != server's {self._lr_shape}"))
                return fut
            self._queue.put((lr, caption, int(cap_len), time.perf_counter(), fut))
        return fut

    def warmup(self, lr_shape=None) -> None:
        """Runs every planned batch size once on the collector thread, so
        the pipeline captures its graph for each before the first request
        (which would otherwise pay the capture). Uses (and pins) the
        server's lr shape; pass lr_shape=[h, w, 3] if neither the
        constructor nor a request gave it. Raises what a capture raised."""
        with self._lock:
            if lr_shape is not None:
                self._lr_shape = tuple(lr_shape)
            if self._lr_shape is None:
                raise ValueError("no lr_shape known: pass warmup(lr_shape=) or "
                                 "construct with lr_shape=")
            if self._closed:
                raise RuntimeError("server closed")
            shape = self._lr_shape

            def run():
                for b in self.planned_sizes:
                    self.pipeline.sr_uint8(np.zeros((b,) + shape, np.float32),
                                           np.ones((b, self._T), np.int32),
                                           np.full((b,), 2, np.int32))

            task = _Task(run, Future())
            self._queue.put(task)
        task.fut.result()

    def close(self, timeout: float = 30.0) -> None:
        """Drain the queue and stop the collector."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._queue.put(None)  # wake the collector
        self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- collector ------------------------------------------------------

    def _plan(self, n: int) -> int:
        for b in self.planned_sizes:
            if b >= n:
                return b
        return self.max_batch

    def _collector(self) -> None:
        while True:
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                with self._lock:
                    if self._closed and self._queue.empty():
                        return
                continue
            if first is None:
                # shutdown wake: keep draining whatever is still queued
                with self._lock:
                    if self._closed and self._queue.empty():
                        return
                continue
            if isinstance(first, _Task):
                self._run_task(first)
                continue
            batch: List[tuple] = [first]
            task = None
            deadline = time.perf_counter() + self.max_delay
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    item = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is None:
                    break
                if isinstance(item, _Task):
                    task = item  # runs after this batch
                    break
                batch.append(item)
            self._run_batch(batch)
            if task is not None:
                self._run_task(task)

    @staticmethod
    def _run_task(task: _Task) -> None:
        if not task.fut.set_running_or_notify_cancel():
            return
        try:
            task.fn()
        except Exception as e:  # the collector survives; the caller gets it
            task.fut.set_exception(e)
        else:
            task.fut.set_result(None)

    def _run_batch(self, batch: List[tuple]) -> None:
        # Claim every rider up front: set_running_or_notify_cancel moves a
        # pending future to RUNNING (after which fut.cancel() can no longer
        # succeed) and returns False for one already cancelled. Without it,
        # a cancel() landing between a done() check and set_result() raises
        # InvalidStateError on this thread and kills the collector.
        batch = [r for r in batch if r[4].set_running_or_notify_cancel()]
        if not batch:
            return
        n = len(batch)
        try:
            b = self._plan(n)
            lrs = np.stack([r[0] for r in batch] + [batch[-1][0]] * (b - n))
            caps = np.stack([r[1] for r in batch] + [batch[-1][1]] * (b - n))
            lens = np.asarray([r[2] for r in batch] + [batch[-1][2]] * (b - n), np.int32)
            out = self.pipeline.sr_uint8(lrs, caps, lens)
        except Exception as e:  # to every rider of this batch: the collector
            # thread must survive any one batch failing
            for r in batch:
                if not r[4].done():  # claimed above: cancel can't race
                    r[4].set_exception(e)
            return
        now = time.perf_counter()
        with self._stats_lock:
            st = self.stats
            st["requests"] += n
            st["batches"] += 1
            st["batch_hist"][b] = st["batch_hist"].get(b, 0) + 1
            lat = st["latency_ms"]
            lat.extend((now - r[3]) * 1e3 for r in batch)
            del lat[:-4096]
        # resolve futures outside the stats lock: set_result runs done-
        # callbacks synchronously, and one of those could read stats
        for i, r in enumerate(batch):
            r[4].set_result(out[i])  # claimed RUNNING above: cannot race

    # ---- monitoring -----------------------------------------------------

    def stats_snapshot(self) -> Dict[str, object]:
        """Consistent copy of the counters for concurrent readers."""
        with self._stats_lock:
            st = self.stats
            return {"requests": st["requests"], "batches": st["batches"],
                    "batch_hist": dict(st["batch_hist"])}

    def latency_percentiles(self) -> Dict[str, float]:
        with self._stats_lock:
            lat = list(self.stats["latency_ms"])
        if not lat:
            return {}
        a = np.asarray(lat)
        return {"p50_ms": float(np.percentile(a, 50)),
                "p99_ms": float(np.percentile(a, 99))}
