"""Metrics and step timing of the trainer (counterpart of
tgsr_tpu/utils/observability.py `StepTimer` and `MetricsLogger`, :37-145).

`MetricsLogger` writes the JAX CLI's `Log/metrics.jsonl` rows ({"step",
"time", metric: float}), with `csv` `Log/metrics.csv`, whose header widens
in place when a new key appears, and with `tensorboard` mirrors every scalar
to event files under `Log/tb` through `torch.utils.tensorboard` where that
imports (it needs the `tensorboard` package), else it prints JAX's
"tensorboard writer unavailable (...); JSONL only" and goes on.
`profile_trace` and `nan_guard` are not ported (ROADMAP A 10).
"""

from __future__ import annotations

import csv as csv_mod
import json
import os
import time
from typing import Any, Dict, Optional


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
