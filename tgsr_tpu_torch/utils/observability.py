"""Tracing, metrics and numerical safety of the trainer and the scripts
(counterpart of tgsr_tpu/utils/observability.py).

- `profile_trace(log_dir)`: a trace of the host and the card
  (`torch.profiler`), written as `log_dir/trace.json` (Chrome / Perfetto).
- `StepTimer`, `MetricsLogger`: `MetricsLogger` writes the JAX CLI's
  `Log/metrics.jsonl` rows ({"step", "time", metric: float}), with `csv`
  `Log/metrics.csv`, whose header widens in place when a new key appears,
  and with `tensorboard` mirrors every scalar to event files under `Log/tb`
  through `torch.utils.tensorboard` where that imports (it needs the
  `tensorboard` package), else it prints JAX's "tensorboard writer
  unavailable (...); JSONL only" and goes on.
- `nan_guard(fn)`: `fn` run under a check of every op, the counterpart of
  `checkify.checkify(fn, errors=checkify.float_checks)`.
"""

from __future__ import annotations

import contextlib
import csv as csv_mod
import functools
import json
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[str]:
    """Trace what runs inside the block, on the host and (where there is
    one) on the card, with `torch.profiler`; on exit the trace is written
    to `log_dir/trace.json` (Chrome trace format: open it in Perfetto or
    chrome://tracing). Yields that path:
    `with profile_trace("/tmp/trace") as path: step()`."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(log_dir, TRACE_FILE)
    with torch.profiler.profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


class StepTimer:
    """EMA of the step's wall time; call `tick()` once a step. The caller
    synchronises the card first when it wants the step's device time in it."""

    DECAY = 0.9

    def __init__(self):
        self.ema_ms: Optional[float] = None
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        if self._last is not None:
            dt = (now - self._last) * 1e3
            self.ema_ms = dt if self.ema_ms is None else (
                self.DECAY * self.ema_ms + (1 - self.DECAY) * dt)
        self._last = now
        return self.ema_ms


class MetricsLogger:
    """Append-only JSONL metrics stream (+ the latest values), and its CSV
    mirror with `csv`: the header is the union of the keys seen, widened in
    place (old rows padded) when a new key appears, and an existing file's
    header is adopted on append."""

    def __init__(self, log_dir: str, csv: bool = False, tensorboard: bool = False):
        os.makedirs(log_dir, exist_ok=True)
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(log_dir, "tb"))
            except Exception as e:  # noqa: BLE001 -- a missing or broken optional package
                print(f"tensorboard writer unavailable ({e}); JSONL only")
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a", buffering=1, encoding="utf-8")
        self.latest: Dict[str, Any] = {}
        self._csv_path = os.path.join(log_dir, "metrics.csv")
        self._csv = None
        self._csv_cols = None
        if csv:
            if os.path.exists(self._csv_path) and os.path.getsize(self._csv_path):
                with open(self._csv_path, newline="", encoding="utf-8") as f:
                    self._csv_cols = next(csv_mod.reader(f), None) or None
            self._open_csv()

    def _open_csv(self) -> None:
        self._csv = open(self._csv_path, "a", buffering=1, newline="", encoding="utf-8")
        self._csv_writer = csv_mod.writer(self._csv)

    def log(self, step: int, **metrics) -> None:
        row: Dict[str, Any] = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                row[k] = v
        self.latest.update(row)
        self._f.write(json.dumps(row) + "\n")
        if self._tb is not None:
            for k, v in row.items():
                if k not in ("step", "time") and isinstance(v, float):
                    self._tb.add_scalar(k, v, int(step))
        if self._csv is None:
            return
        if self._csv_cols is None:
            self._csv_cols = list(row)
            self._csv_writer.writerow(self._csv_cols)
        elif any(k not in self._csv_cols for k in row):
            self._csv_cols += [k for k in row if k not in self._csv_cols]
            self._csv.close()
            with open(self._csv_path, newline="", encoding="utf-8") as f:
                old = list(csv_mod.reader(f))[1:]
            with open(self._csv_path, "w", newline="", encoding="utf-8") as f:
                w = csv_mod.writer(f)
                w.writerow(self._csv_cols)
                for cells in old:
                    w.writerow(cells + [""] * (len(self._csv_cols) - len(cells)))
            self._open_csv()
        self._csv_writer.writerow([str(row.get(c, "")) for c in self._csv_cols])

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._csv is not None:
            self._csv.close()
        self._f.close()


class FloatCheckError(RuntimeError):
    """What `nan_guard` raises: the first float error of the call."""


# ops JAX's NaN check passes over: its list holds only the primitives that can
# make a NaN (checkify.nan_primitives); views, copies, casts, selections,
# max / min / clamp, sign and rounding, comparisons and factories are not in it
_UNCHECKED = frozenset("""
    _to_copy _unsafe_view _reshape_alias abs alias amax amin argmax argmin as_strided cat ceil
    chunk clamp clamp_max clamp_min clone contiguous copy detach diagonal embedding empty
    empty_like empty_strided eq expand fill flip floor full full_like gather ge gt hardtanh
    index index_put index_select isfinite isinf isnan le lift_fresh logical_and logical_not
    logical_or lt masked_fill max max_pool2d_with_indices maximum min minimum narrow ne neg
    new_empty new_full new_ones new_zeros ones ones_like permute relu repeat reshape roll round
    scalar_tensor scatter select sign slice sort split split_with_sizes squeeze stack t
    threshold_backward topk transpose trunc unbind unfold unsqueeze view where zero zeros
    zeros_like _local_scalar_dense
""".split())
# ops JAX checks for a zero divisor (its div primitive; `1 / x` in torch is
# reciprocal); remainder and fmod are JAX's rem, which has no such check
_DIVISIONS = frozenset(("div", "floor_divide", "true_divide", "reciprocal"))


def _op_name(func) -> str:
    name = func.overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.endswith("__") else name


class _FloatChecks(TorchDispatchMode):
    """Records, op by op, whether a division had a zero divisor and whether
    an op of JAX's NaN list put out a NaN; as device flags, read once at the
    end, so that the card is not synchronised per op."""

    def __init__(self):
        super().__init__()
        self.flags: List[Tuple[str, torch.Tensor]] = []

    def _record(self, message: str, flag) -> None:
        if isinstance(flag, torch.Tensor):
            self.flags.append((message, flag))
        elif flag:
            self.flags.append((message, torch.tensor(True)))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _op_name(func)
        if name in _DIVISIONS:
            divisor = args[0] if name == "reciprocal" else (args[1] if len(args) > 1
                                                             else kwargs.get("other"))
            if isinstance(divisor, torch.Tensor):
                zero = (divisor == 0).any()
                if not divisor.is_floating_point() and divisor.device.type == "cpu" and zero:
                    # torch's own integer kernel would raise first: raise as JAX does
                    raise FloatCheckError(f"division by zero ({func})")
                self._record(f"division by zero ({func})", zero)
            else:
                self._record(f"division by zero ({func})", divisor == 0)
        out = func(*args, **kwargs)
        if name not in _UNCHECKED:
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex()):
                    self._record(f"nan generated by op: {func}", torch.isnan(t).any())
        return out

    def throw(self) -> None:
        if not self.flags:
            return
        hit = torch.stack([f.to(device="cpu", non_blocking=False).reshape(())
                           for _, f in self.flags])
        if bool(hit.any()):
            raise FloatCheckError(self.flags[int(hit.to(torch.uint8).argmax())][0])


def nan_guard(fn: Callable) -> Callable:
    """`fn` wrapped so that a float error in any op it runs raises
    FloatCheckError instead of propagating, the counterpart of JAX's
    `checkify.checkify(fn, errors=checkify.float_checks)` + `err.throw()`:

    - an op of JAX's NaN list (arithmetic, reductions, matmul and conv,
      transcendental functions, pad; not views, copies, casts,
      concatenation, selection, max / min / clamp / relu, rounding or
      comparisons) whose output holds a NaN: "nan generated by op: <op>".
      A NaN passed in raises at the first such op that reads it (as JAX
      raises at its first such primitive) and passes through the others;
    - a division whose divisor holds a zero, float or integer: "division
      by zero (<op>)". So an Inf from a float divide by zero raises, as in
      JAX; an Inf from anything else (exp of a large number, log of 0) does
      not;
    - an integer remainder by zero is no float error in JAX (it returns a
      value); torch's CPU kernel raises its own error there.

    Where it cannot follow JAX: it sees aten ops (and the port's
    `torch.ops.tgsr` kernels) as torch dispatches them, not JAX's
    primitives, so it names another op than JAX's message does, and a NaN
    made and consumed inside one fused op (a hand-written kernel, a
    cuDNN call) is seen only if it reaches that op's output; and torch
    writes `1 / x` as reciprocal, which it counts as a division, where JAX's
    `x ** -1` has no division check. The flags are read once, after `fn`
    returns: the first error in program order is raised, as `err.throw()`
    raises the first. A clean call returns exactly what `fn` returns."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        mode = _FloatChecks()
        with mode:
            out = fn(*args, **kwargs)
        mode.throw()
        return out

    return wrapper
