"""Rematerialisation (counterpart of flax's `nn.remat`, which the JAX
package applies per stage and per block, tgsr_tpu/models/generator.py:155-163,
generator_hf.py:110-113, models16.py:50-55 and :124-131).

`remat(module, *args)` runs `module(*args)` under
`torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`: none of the
module's inner activations is kept for the backward, which runs the module
again to recompute them. The module's parameters are read when the call is
made and handed to the checkpoint as inputs, so that the recompute runs on
the same tensors as the forward: the bfloat16 copies that
`engine/precision.call_cast` swaps in for its call, which are gone from the
module by the time the backward runs. The cast is not made again.

The recompute runs with `recomputing()` true. Train-mode BatchNorm
(`ops/blocks.BatchNorm`) reads it and does not blend its running stats a
second time: flax's remat returns the stats of the forward once. Its output
does not depend on the running stats (it normalises with the batch's own
moments), so the recomputed activations are the forward's.

`remat_policy` reads the JAX trainer's `remat` argument.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Iterator, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

POLICIES = (False, True, "all", "low", "high")
_STATE = threading.local()


def recomputing() -> bool:
    """True inside the backward's recompute of a `remat` call, on this thread."""
    return getattr(_STATE, "recomputing", False)


@contextlib.contextmanager
def _recompute() -> Iterator[None]:
    before = recomputing()
    _STATE.recomputing = True
    try:
        yield
    finally:
        _STATE.recomputing = before


def _contexts():
    return contextlib.nullcontext(), _recompute()


def remat(module: nn.Module, *args, **kwargs) -> Any:
    """`module(*args, **kwargs)`, its activations recomputed in the backward.
    Outside autograd (no_grad, eval) a plain call."""
    if not torch.is_grad_enabled():
        return module(*args, **kwargs)
    names, tensors = zip(*module.named_parameters())

    def run(tensors, *args):
        return torch.func.functional_call(module, dict(zip(names, tensors)), args, kwargs,
                                          tie_weights=False)  # as call_cast: aliases swap once

    return checkpoint(run, tensors, *args, use_reentrant=False, context_fn=_contexts)


def remat_policy(remat) -> Tuple[bool, bool]:
    """(low, high): whether GSRNetLow's stages and NetGHighWeight's blocks
    recompute, for the JAX trainer's False / True / 'all' / 'low' / 'high'
    (tgsr_tpu/engine/gan_trainer.py:139-141, its message)."""
    if remat not in POLICIES:
        raise ValueError(f"remat must be False/True/'all'/'low'/'high', got {remat!r}")
    return remat in (True, "all", "low"), remat in (True, "all", "high")
