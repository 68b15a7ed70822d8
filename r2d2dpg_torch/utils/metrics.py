"""Metric logging: sliding percentile windows and a CSV scalar logger.

Port of ``r2d2dpg_tpu/utils/metrics.py`` (no JAX there either; copied so
the port imports nothing of the JAX package):

- ``PercentileWindow``: the recent-window p50/p99 that serving health and
  the registry's histograms read;
- ``MetricLogger``: CSV (always) + TensorBoard when ``tensorboardX``
  imports; every row is stamped with wall-clock seconds since start
  (return @ wall-clock), ``rates`` turns monotone counters into per-second
  rates, and a logdir that already holds a CSV is appended to with the
  wall clock carried on.
"""

from __future__ import annotations

import collections
import csv
import math
import os
import threading
import time
from typing import Dict, Iterable, Optional, Tuple


class PercentileWindow:
    """Sliding window of scalar observations with percentile read-off.

    Serving health (queue wait, policy-step latency) needs p50/p99 over the
    *recent* past, not the whole process lifetime — a bounded deque of the
    last ``size`` observations is that window.  ``add`` is O(1);
    ``percentiles`` sorts the window (a few thousand floats) only when a
    snapshot is actually taken.  Thread-safe: producers (the serving worker)
    and consumers (health scrapes from request threads) run concurrently.
    """

    def __init__(self, size: int = 2048):
        if size < 1:
            raise ValueError("size must be >= 1")
        self._buf: collections.deque = collections.deque(maxlen=size)
        self._lock = threading.Lock()
        self._count = 0
        self._total = 0.0

    def add(self, value: float) -> None:
        with self._lock:
            self._buf.append(float(value))
            self._count += 1
            self._total += float(value)

    @property
    def count(self) -> int:
        """Total observations ever added (not just those still windowed)."""
        return self._count

    @property
    def total(self) -> float:
        """Running sum of ALL observations ever added (not windowed)."""
        return self._total

    @staticmethod
    def _nearest_rank(data, qs) -> Tuple[float, ...]:
        if not data:
            return tuple(0.0 for _ in qs)
        out = []
        for q in qs:
            # Nearest-rank: ceil(q/100 * n) - 1, clamped to the window.
            rank = math.ceil(q / 100.0 * len(data)) - 1
            out.append(data[max(0, min(len(data) - 1, rank))])
        return tuple(out)

    def percentiles(self, qs: Iterable[float] = (50.0, 99.0)) -> Tuple[float, ...]:
        """Nearest-rank percentiles over the current window (0.0 if empty)."""
        with self._lock:
            data = sorted(self._buf)
        return self._nearest_rank(data, qs)

    def snapshot(self) -> Tuple[int, float, float, float]:
        """One consistent ``(count, total, p50, p99)`` read under ONE lock
        (the registry's histogram export): separate reads could let a
        producer slip observations in between them."""
        with self._lock:
            count, total = self._count, self._total
            data = sorted(self._buf)
        p50, p99 = self._nearest_rank(data, (50.0, 99.0))
        return count, total, p50, p99

    def reset(self) -> None:
        """Drop the window AND the lifetime count/total."""
        with self._lock:
            self._buf.clear()
            self._count = 0
            self._total = 0.0


class MetricLogger:
    """Scalar logger: ``<logdir>/metrics.csv``, plus TensorBoard when
    ``tensorboardX`` imports.

    ``log(step, scalars)`` stamps every row with wall-clock seconds since
    construction; ``rates(env_steps=..., ...)`` turns monotone counters into
    per-second rates.  A logdir that already holds a CSV is appended to,
    with the wall clock carried on.  Thread-safe: the serving worker logs
    while other threads own the logger.
    """

    def __init__(self, logdir: str):
        self.logdir = logdir
        self.t0 = time.monotonic()
        self._lock = threading.RLock()
        self._csv_path = os.path.join(logdir, "metrics.csv")
        self._csv_file = None
        self._csv_writer = None
        self._csv_fields: Optional[list] = None
        self._last_rate_t: Optional[float] = None
        self._last_counts: Dict[str, float] = {}
        os.makedirs(logdir, exist_ok=True)
        if os.path.exists(self._csv_path):
            # Resume into an existing logdir: keep the old rows and continue
            # the wall clock from where the previous run left off, so the
            # return@wall-clock curve survives a restart.
            with open(self._csv_path, newline="") as f:
                old = list(csv.DictReader(f))
            if old:
                self._csv_fields = list(old[0].keys())
                try:
                    self.t0 -= max(
                        float(r["wall_seconds"]) for r in old if r.get("wall_seconds")
                    )
                except ValueError:
                    pass
        try:
            from tensorboardX import SummaryWriter

            self._tb = SummaryWriter(logdir)
        except ImportError:  # optional: the CSV is the record
            self._tb = None

    # ------------------------------------------------------------------ rates
    def rates(self, **counts: float) -> Dict[str, float]:
        """Steps/sec for monotone counters since the previous ``rates`` call.

        ``rates(env_steps=..., learner_steps=...)`` returns e.g.
        ``{"env_steps_per_sec": ..., "learner_steps_per_sec": ...}``.
        """
        with self._lock:
            now = time.monotonic()
            out: Dict[str, float] = {}
            if self._last_rate_t is not None:
                dt = max(now - self._last_rate_t, 1e-9)
                for k, v in counts.items():
                    prev = self._last_counts.get(k)
                    if prev is not None:
                        out[f"{k}_per_sec"] = (v - prev) / dt
            self._last_rate_t = now
            self._last_counts = dict(counts)
            return out

    # -------------------------------------------------------------------- log
    def log(self, step: int, scalars: Dict[str, float]) -> None:
        elapsed = time.monotonic() - self.t0
        row = {"step": step, "wall_seconds": round(elapsed, 3)}
        row.update({k: float(v) for k, v in scalars.items()})
        with self._lock:
            if self._csv_writer is None or any(k not in self._csv_fields for k in row):
                self._reopen_csv(row)
            self._csv_writer.writerow({k: row.get(k, "") for k in self._csv_fields})
            self._csv_file.flush()
            if self._tb is not None:
                for k, v in row.items():
                    if k != "step":
                        self._tb.add_scalar(k, v, global_step=step)

    def _reopen_csv(self, row: Dict[str, float]) -> None:
        """(Re)open the CSV; rewrite existing rows ONLY on a header change.

        Appending under an unchanged header is the common case (resume into
        an existing logdir, or a plain first open); the full
        read-all/rewrite-all pass — O(rows) per occurrence — happens only
        when a genuinely new column appears, not on every (re)open, so a
        long run no longer pays O(rows²) across its lifetime."""
        if self._csv_file is not None:
            self._csv_file.close()
            self._csv_file = self._csv_writer = None
        fields = list(
            dict.fromkeys(
                ["step", "wall_seconds"]
                + (self._csv_fields or [])
                + list(row)
            )
        )
        exists = os.path.exists(self._csv_path)
        if exists and self._csv_fields == fields:
            # Header already covers the row (e.g. resume): append, no rewrite.
            self._csv_file = open(self._csv_path, "a", newline="")
            self._csv_writer = csv.DictWriter(
                self._csv_file, fieldnames=fields
            )
            return
        old_rows = []
        if exists:
            with open(self._csv_path, newline="") as f:
                old_rows = list(csv.DictReader(f))
        self._csv_file = open(self._csv_path, "w", newline="")
        self._csv_writer = csv.DictWriter(self._csv_file, fieldnames=fields)
        self._csv_writer.writeheader()
        for r in old_rows:
            self._csv_writer.writerow({k: r.get(k, "") for k in fields})
        self._csv_fields = fields

    # ------------------------------------------------------------------ close
    def close(self) -> None:
        with self._lock:
            if self._csv_file is not None:
                self._csv_file.close()
                self._csv_file = self._csv_writer = None
            if self._tb is not None:
                self._tb.close()
                self._tb = None
