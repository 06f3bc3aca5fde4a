"""Batch loading and preprocessing (counterpart of tgsr_tpu/data/pipeline.py):
`BatchLoader`, images decoded and captions encoded on a background thread,
numpy batches yielded in order; `device_preprocess`, the training batch's
pyramid, LR and bicubic (and blurred) copies made on the device from the
uint8 HR; `device_prefetch`, the host-to-device copies of the next batches
made on a side stream while the current step runs.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from collections import deque
from typing import Any, Callable, Dict, Iterator, Optional, Union

import numpy as np
import torch

from tgsr_tpu_torch.data.datasets import prepare_batch
from tgsr_tpu_torch.ops.image import build_pyramid, gaussian_blur, normalize_uint8, resize
from tgsr_tpu_torch.parallel.multihost import land_batch


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
    one worker thread per epoch fills a queue of `prefetch` batches. With
    `mesh` each rank gets its rows of every global batch
    (`parallel.multihost.process_local_slice`): every rank decodes the whole
    batch, so that the random draws (captions, crops) are the
    single-process stream's.

    Two guarantees: an exception in the worker (a decode error) reaches the
    consumer, raised from the generator; and a consumer that abandons the
    generator (breaks out of the loop, or drops it) releases the worker,
    which stops at its next put instead of blocking on a full queue."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True, deterministic_captions: bool = False,
                 prefetch: int = 2, mesh=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.deterministic_captions = deterministic_captions
        self.prefetch = prefetch
        self.mesh = mesh

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
                    batch = prepare_batch(examples)
                    if self.mesh is not None:
                        batch = land_batch(batch, self.mesh)
                    if not _put(batch):
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


def _to_device(tree: Any, device: torch.device, stream) -> Any:
    """numpy arrays and tensors of `tree` on `device` (from pinned host
    memory, non-blocking, on `stream` where given); lists of strings and
    other leaves as they are."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device, stream) for k, v in tree.items()}
    if isinstance(tree, list) and tree and isinstance(tree[0], str):
        return tree
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device, stream) for v in tree)
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(tree)
    if not isinstance(tree, torch.Tensor):
        return tree
    if device.type != "cuda":
        return tree.to(device)
    with torch.cuda.stream(stream):
        return tree.pin_memory().to(device, non_blocking=True)


def _tensors(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def device_prefetch(batches: Iterator[Dict[str, Any]], depth: int = 2,
                    device: Optional[Union[str, torch.device]] = None,
                    put: Optional[Callable[[Any], Any]] = None) -> Iterator[Dict[str, Any]]:
    """The batches of `batches` with their arrays on `device`, each copied
    `depth` batches ahead of its use (counterpart of
    tgsr_tpu/data/pipeline.py:139; the role of torch's pin_memory +
    non_blocking): on a card, from pinned host memory on a side stream, the
    consumer's stream waiting for each batch's copies when it is handed out;
    on the CPU the arrays become tensors that share their memory; with
    `device` None the batches pass as they are. `put`: a per-batch landing of the caller's in place of the
    copy (a rank's rows, `parallel.mesh.shard_batch`), also run `depth`
    ahead. Lists of strings (prepare_batch's "keys") and scalars pass
    through. Closing the iterator early drops what it holds."""
    dev = None if device is None else torch.device(device)
    stream = torch.cuda.Stream(dev) if dev is not None and dev.type == "cuda" else None
    if put is None:
        def put(tree):
            return tree if dev is None else _to_device(tree, dev, stream)

    def land(tree):
        out = put(tree)
        if stream is None:
            return out, None
        event = torch.cuda.Event()
        event.record(stream)
        return out, event

    def hand_out(item):
        out, event = item
        if event is not None:
            current = torch.cuda.current_stream(dev)
            current.wait_event(event)
            for t in _tensors(out):
                if t.device.type == "cuda":
                    t.record_stream(current)
        return out

    buf: deque = deque()
    it = iter(batches)
    try:
        while True:
            while len(buf) < depth:
                try:
                    buf.append(land(next(it)))
                except StopIteration:
                    while buf:
                        yield hand_out(buf.popleft())
                    return
            yield hand_out(buf.popleft())
    finally:
        buf.clear()
