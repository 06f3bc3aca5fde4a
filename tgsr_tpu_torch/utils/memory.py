"""Device memory budget and microbatch planning from the card itself
(counterpart of tgsr_tpu/utils/memory.py `device_memory_budget` and
`max_feasible_batch`, which read XLA's compile-time memory plan).

PyTorch has no compile-time plan, so the need of a microbatch is measured:
the peak of the bytes the caching allocator reserves for it, above what it
reserved before, with its cache emptied first (`reset_peak_memory_stats`,
`max_memory_reserved`), at two probe batches, fitted as fixed bytes plus
bytes per image. The budget is the free device memory `mem_get_info`
reports times BUDGET_FRACTION. A microbatch is served through a captured
CUDA graph (engine/graphs.py), whose pool keeps the forward's working set
after the capture; the next capture's eager warm-up (or a caller's eager
forward) runs beside it. So the plan fits GRAPH_COPIES working sets, plus
the bytes the pipeline's other graphs hold per image of their batch (their
static inputs and outputs).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, Iterator

import torch

BUDGET_FRACTION = 0.9  # headroom for the CUDA context's own allocations and fragmentation
GRAPH_COPIES = 2  # a captured graph's pool and the eager warm-up before its capture
MAX_MICROBATCH = 4096  # the top of the JAX package's search
PROBE_SPAN = 4  # the probes run at one quantum and at this many


@dataclass(frozen=True)
class MemoryPlan:
    microbatch: int
    fixed_bytes: int  # need of a forward = fixed_bytes + per_image_bytes * b
    per_image_bytes: int
    held_per_image_bytes: int  # what the other graphs hold, per image of their batch
    budget_bytes: int
    probes: Dict[int, int]  # probe batch -> its measured need in bytes


def device_memory_budget(device: torch.device) -> int:
    """Bytes a plan may use on `device`: the free bytes `mem_get_info`
    reports times BUDGET_FRACTION (call torch.cuda.empty_cache() first to
    count what the caching allocator holds unused as free)."""
    free, _ = torch.cuda.mem_get_info(device)
    return int(free * BUDGET_FRACTION)


def peak_bytes(fn: Callable[[], object], device: torch.device) -> int:
    """Peak reserved bytes of fn() above those reserved before it, the
    allocator's cache emptied first (so the count includes the rounding and
    fragmentation of the blocks fn takes)."""
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved(device)
    torch.cuda.reset_peak_memory_stats(device)
    fn()
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_reserved(device) - base


@contextlib.contextmanager
def reserved_cap(device: torch.device, budget_bytes: int) -> Iterator[None]:
    """For the block, the caching allocator may reserve at most what it
    holds now plus `budget_bytes` (`set_per_process_memory_fraction`);
    beyond that an allocation raises OutOfMemoryError, and cuDNN falls back
    to an algorithm with a smaller workspace, as on a full card. The
    fraction set before is restored after."""
    index = torch.cuda.current_device() if device.index is None else device.index
    total = torch.cuda.get_device_properties(index).total_memory
    before = torch.cuda.get_per_process_memory_fraction(index)
    cap = torch.cuda.memory_reserved(index) + budget_bytes
    torch.cuda.set_per_process_memory_fraction(min(1.0, cap / total), index)
    try:
        yield
    finally:
        torch.cuda.set_per_process_memory_fraction(before, index)


def fit(probes: Dict[int, int]):
    """(fixed, per_image) bytes through the two probes, per_image >= 0."""
    (b1, n1), (b2, n2) = sorted(probes.items())
    per_image = max(0, -(-(n2 - n1) // (b2 - b1)))
    return max(0, n1 - per_image * b1), per_image


def max_microbatch(fixed: int, per_image: int, budget: int, quantum: int,
                   held_per_image: int = 0, lo: int = 1, hi: int = MAX_MICROBATCH) -> int:
    """Largest b <= hi with GRAPH_COPIES * (fixed + per_image * b) +
    held_per_image * b <= budget, rounded down to a multiple of `quantum`
    when it is at least that, else to a power of two, and never below lo
    (JAX's bisection tries lo itself first). Raises when not even lo fits."""
    room = budget - GRAPH_COPIES * fixed
    per = GRAPH_COPIES * per_image + held_per_image
    b = 0 if room < 0 else min(hi, room // per if per else hi)
    lo = max(lo, 1)
    if b < lo:
        raise RuntimeError(f"no microbatch of at least {lo} fits: {GRAPH_COPIES} x ({fixed} + "
                           f"{per_image} x b) + {held_per_image} x b bytes against a budget of "
                           f"{budget}")
    return max(lo, b - b % quantum if b >= quantum else 1 << (b.bit_length() - 1))


def plan(need: Callable[[int], int], budget: int, quantum: int,
         held_per_image: int = 0, lo: int = 1, hi: int = MAX_MICROBATCH) -> MemoryPlan:
    """Measures `need(b)` (bytes) at b = quantum and PROBE_SPAN * quantum
    and plans the microbatch in [lo, hi] against `budget`."""
    measured = {b: need(b) for b in (quantum, PROBE_SPAN * quantum)}
    fixed, per_image = fit(measured)
    return MemoryPlan(max_microbatch(fixed, per_image, budget, quantum, held_per_image, lo, hi),
                      fixed, per_image, held_per_image, budget, measured)
