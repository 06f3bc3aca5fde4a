"""SIGTERM onto the graceful Ctrl-C path (counterpart of
tgsr_tpu/utils/preemption.py): container stops and batch schedulers announce
the end with SIGTERM, which the CLIs then drain like a KeyboardInterrupt."""

from __future__ import annotations

import contextlib
import signal


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
