"""The serving forward of one microbatch, captured once as a CUDA graph and
replayed (counterpart of tgsr_tpu/engine/inference.py `forward_scan`, which
runs its microbatches in one compiled dispatch).

Eagerly, each of the forward's few hundred launches costs the host tens of
microseconds of Python, while many take the card less; a replay launches
the whole captured forward at once. `SRPipeline` keeps one `ForwardGraph`
per (graph batch, LR size, caption length, LR dtype), at most MAX_GRAPHS of
them, and replays it for every microbatch of that shape
(engine/inference.py `_graph`).

- Inputs live in static device buffers made by the caller (the LR image,
  uint8 or float32, token ids and lengths). `__call__` copies the caller's
  tensors into them outside the graph, replays, and returns the static
  output, which the next replay overwrites: the caller copies it out first.
- Before the capture comes one eager warm-up at the same shapes, on a side
  stream, so that every kernel library is built and loaded, every module has
  made its first launch, and cuDNN has chosen its algorithms (the port keeps
  cudnn.benchmark off, so the choice is cuDNN's heuristic for the shape, the
  same for the capture and for an eager call).
- A capture that fails raises; nothing runs the forward eagerly instead.
- Launch counts: while capturing, the kernel wrappers add to
  `_build.LAUNCHES` as they record each launch into the graph. Those counts
  are kept here as `launches` and taken back out of `_build.LAUNCHES`, since
  the capture ran nothing; each replay adds them to `_build.REPLAYED`.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Hashable, Tuple

import torch

from tgsr_tpu_torch.ops import _build

# sr_batched rounds its balanced microbatch up to a multiple of this, as the
# JAX package does (which still leaves b = N for every N below the
# microbatch); on the card a microbatch of b is replayed at `graph_batch(b)`
MICROBATCH_QUANTUM = 64
# the captured graphs a pipeline keeps, least recently used dropped first:
# each holds its static inputs and output, which the memory plan counts
MAX_GRAPHS = 16


def graph_batch(b: int) -> int:
    """The batch a microbatch of b replays at on the card: the next power of
    two up to MICROBATCH_QUANTUM, then the next multiple of it. So the sizes
    1..4096 map onto 70 graph batches, and a planned microbatch
    (`memory.max_microbatch`) is one of them. `SRPipeline` and
    `engine/aot.AOTPipeline` both pad to it."""
    if b <= MICROBATCH_QUANTUM:
        return 1 << (b - 1).bit_length()
    return -(-b // MICROBATCH_QUANTUM) * MICROBATCH_QUANTUM


class ForwardGraph:
    """`forward(lr, captions, cap_lens) -> tensor` captured on the static
    buffers `inputs` (device tensors) into `pool`, a
    `torch.cuda.graph_pool_handle()` the caller may share between graphs
    whose replays never overlap."""

    def __init__(self, forward: Callable[..., torch.Tensor],
                 inputs: Tuple[torch.Tensor, torch.Tensor, torch.Tensor], pool: tuple):
        self.inputs = inputs
        device = inputs[0].device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            forward(*inputs)  # the warm-up
        torch.cuda.current_stream(device).wait_stream(side)
        before = dict(_build.LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool):
            self.out = forward(*inputs)
        self.launches = {name: _build.LAUNCHES[name] - n for name, n in before.items()}
        _build.LAUNCHES.update(before)
        self.replays = 0

    def __call__(self, *args: torch.Tensor) -> torch.Tensor:
        for buf, x in zip(self.inputs, args):
            buf.copy_(x)
        self.graph.replay()
        self.replays += 1
        for name, n in self.launches.items():
            _build.REPLAYED[name] += n
        return self.out


class GraphCache(OrderedDict):
    """One pipeline's captured forwards by key, least recently used first,
    all in one memory pool (`SRPipeline.graphs`, `aot.AOTPipeline.graphs`).

    One pool for all of them, so that their working sets overlap instead of
    adding up. Safe because of the owner's lock: whoever captures or replays
    holds it from the copy-in to the copy of the output out, on one stream,
    so no two replays or captures overlap and each replay's output is copied
    out before any graph replays again; each kept graph's static inputs and
    output stay allocated (no other capture takes them; a dropped graph is
    never replayed again); what two graphs share is scratch that every
    replay writes before it reads."""

    def __init__(self):
        super().__init__()
        self.pool = None

    def graph(self, key: Hashable, forward: Callable[..., torch.Tensor],
              make_inputs: Callable[[], Tuple[torch.Tensor, ...]], limit: int,
              device: torch.device) -> ForwardGraph:
        """The graph of `key`, captured from `forward` on `make_inputs()` at
        first use; past `limit` graphs the least recently used one is
        dropped, with its inputs and output. The caller holds its lock."""
        if key in self:
            self.move_to_end(key)
            return self[key]
        if len(self) >= limit:
            torch.cuda.synchronize(device)  # no replay of it is in flight
            self.popitem(last=False)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        self[key] = ForwardGraph(forward, make_inputs(), self.pool)
        return self[key]
