"""Batch loading and preprocessing (counterpart of tgsr_tpu/data/pipeline.py):
`BatchLoader`, images decoded and captions encoded on a background thread,
numpy batches yielded in order; `device_preprocess`, the training batch's
pyramid, LR and bicubic (and blurred) copies made on the device from the
uint8 HR. `device_prefetch` is not ported (ROADMAP A 9): the trainer copies
each batch when it takes it.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Any, Dict, Iterator

import numpy as np
import torch

from tgsr_tpu_torch.data.datasets import prepare_batch
from tgsr_tpu_torch.ops.image import build_pyramid, gaussian_blur, normalize_uint8, resize


def device_preprocess(hr_uint8: torch.Tensor, n_branches: int, base_size: int,
                      with_blur: bool = True) -> Dict[str, Any]:
    """hr_uint8 [B, H, W, 3] (on the device that should do the work) -> the
    per-branch tensors, NHWC float32 in [-1, 1], as JAX's jitted function
    (tgsr_tpu/data/pipeline.py:32-50; = prepare_datablur's contract):
      pyramid[i] = resize(HR, base * 2^i), lr = pyramid[0],
      bic[i]     = cubic resize of the LR to each pyramid size (bic[0] = lr),
      blur_pyramid / bic_blur: gaussian_blur(radius 2) copies, with_blur."""
    hr = normalize_uint8(hr_uint8)
    pyramid = build_pyramid(hr, n_branches, base_size)
    lr = pyramid[0]
    bic = [resize(lr, (p.shape[1], p.shape[2]), "cubic") if i > 0 else lr
           for i, p in enumerate(pyramid)]
    out = {"pyramid": pyramid, "lr": lr, "bic": bic}
    if with_blur:
        out["blur_pyramid"] = [gaussian_blur(p, 2.0) for p in pyramid]
        out["bic_blur"] = [gaussian_blur(b, 2.0) for b in bic]
    return out


class BatchLoader:
    """A threaded host loader (the reference's DataLoader(num_workers) role):
    one worker thread per epoch fills a queue of `prefetch` batches.

    Two guarantees: an exception in the worker (a decode error) reaches the
    consumer, raised from the generator; and a consumer that abandons the
    generator (breaks out of the loop, or drops it) releases the worker,
    which stops at its next put instead of blocking on a full queue."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True, deterministic_captions: bool = False,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.deterministic_captions = deterministic_captions
        self.prefetch = prefetch

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        return idx

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, Any]]:
        rng = np.random.default_rng(self.seed + 1000 * epoch)
        idx = self._indices(epoch)
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        n_batches = len(self)
        stop = threading.Event()

        def _put(item) -> bool:
            # a bounded put that notices the consumer leaving: without the
            # stop check, a consumer that breaks out early would leave this
            # thread blocked on q.put for good, with its buffered batches
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def worker():
            # the end of the epoch or its error is always delivered: a decode
            # error must reach the consumer, not leave it waiting on q.get()
            try:
                for b in range(n_batches):
                    sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
                    if len(sel) < self.batch_size and self.drop_last:
                        break
                    examples = [self.dataset.__getitem__(
                        int(i), rng=rng, sent_ix=0 if self.deterministic_captions else None)
                        for i in sel]
                    if not _put(prepare_batch(examples)):
                        return
            except BaseException as e:  # noqa: BLE001 -- handed to the consumer, raised there
                _put(e)
                return
            _put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # the generator closed or abandoned: release the worker
            stop.set()
