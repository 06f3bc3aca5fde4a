"""Preemption handling (counterpart of tgsr_tpu/utils/preemption.py):
container stops and batch schedulers announce the end with SIGTERM.

`graceful_sigterm` turns SIGTERM into a KeyboardInterrupt, which a CLI
drains like Ctrl-C. The GAN training CLI, whose state is updated in place
and whose checkpoint is a collective of every rank, takes `graceful_stop`
instead: SIGTERM and Ctrl-C only set a flag, and the loop stops at the end
of a step; `stop_agreed` reduces the flag over the ranks after every step,
so that every rank stops after the same step (a signal reaches the ranks at
different steps) and the final checkpoint is taken by all of them together.
The reduction runs on a gloo group of its own (`stop_group`): the checkpoint
writer's background thread runs its collectives on another, and gloo pairs
the collectives of one group by their order on each rank, which two threads
do not keep. A second signal raises KeyboardInterrupt at once.
"""

from __future__ import annotations

import contextlib
import signal
from typing import Iterator, Optional


@contextlib.contextmanager
def graceful_sigterm():
    """Raise KeyboardInterrupt in this process on SIGTERM.

    Yields True when the handler was installed, False when it could not be
    (handlers install from the main thread only, e.g. not in a CLI's main()
    driven from a worker thread); the previous handler is restored on exit
    either way."""
    def _raise(signum, frame):
        raise KeyboardInterrupt(f"signal {signum}")

    try:
        prev = signal.signal(signal.SIGTERM, _raise)
    except ValueError:  # not the main thread
        yield False
        return
    try:
        yield True
    finally:
        signal.signal(signal.SIGTERM, prev)


class StopFlag:
    """What `graceful_stop` records: the first signal's number, or None."""

    def __init__(self):
        self.signum: Optional[int] = None
        self.installed = False

    @property
    def requested(self) -> bool:
        return self.signum is not None


@contextlib.contextmanager
def graceful_stop(signals=(signal.SIGTERM, signal.SIGINT)) -> Iterator[StopFlag]:
    """Within: the first SIGTERM or SIGINT sets the yielded flag, a second
    raises KeyboardInterrupt. From the main thread only (elsewhere the
    handlers cannot install, `flag.installed` is False and nothing is
    caught); the previous handlers are restored on exit."""
    flag = StopFlag()

    def _note(signum, frame):
        if flag.requested:
            raise KeyboardInterrupt(f"signal {signum}")
        flag.signum = signum

    prev = {}
    try:
        for s in signals:
            prev[s] = signal.signal(s, _note)
        flag.installed = True
    except ValueError:  # not the main thread
        pass
    try:
        yield flag
    finally:
        for s, handler in prev.items():
            signal.signal(s, handler)


def stop_group():
    """A gloo group of every rank for `stop_agreed` alone, or None without a
    process group of more than one rank. Every rank calls it, in the same
    order as its other `new_group` calls. No other thread may use the group
    (a collective of another thread could meet the flag's reduction)."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    return dist.new_group(backend="gloo")


def stop_agreed(flag: StopFlag, group=None) -> bool:
    """Whether any rank's flag is set: a max over `group` (`stop_group`'s;
    every rank of it calls this after every step), or this rank's flag alone
    without one."""
    if group is None:
        return flag.requested
    import torch
    import torch.distributed as dist

    t = torch.tensor([int(flag.requested)])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())
