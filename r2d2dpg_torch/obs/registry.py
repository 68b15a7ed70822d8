"""Typed instrument registry: the process-wide telemetry namespace.

Port of ``r2d2dpg_tpu/obs/registry.py`` (pure Python; copied so the port
imports nothing of the JAX package).  Three Prometheus-shaped instrument
kinds, ``Counter`` (monotone ``inc``), ``Gauge`` (``set``, or ``set_fn``
evaluated at snapshot time) and ``Histogram`` (a sliding
``PercentileWindow``, exported as a summary), each optionally labelled
(``labelnames`` at registration, ``.labels(...)`` to bind).  Registering a
name twice with the same spec returns the existing instrument; with
another spec it raises.  ``get_registry()`` is the process singleton the
serving stack publishes into.

Names follow ``r2d2dpg_<subsystem>_<metric>``, ``_total`` for counters and
``_seconds`` for time histograms.  The Prometheus text rendering comes
with the exporter (the telemetry slice), the cross-process federation
(``RemoteMirror``, ``merge_remote``, ``allgather_into_mirror``) with the
fleet and multi-device slices.
"""

from __future__ import annotations

import re
import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from r2d2dpg_torch.utils.metrics import PercentileWindow

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid metric name {name!r}")
    return name


class _Instrument:
    """Shared shell: name/help/labelnames + the labelset -> cell table."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...]):
        self.name = _check_name(name)
        self.help = help
        self.labelnames = tuple(labelnames)
        for ln in self.labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self._lock = threading.Lock()
        self._cells: Dict[Tuple[str, ...], object] = {}
        if not self.labelnames:
            self._cells[()] = self._new_cell()

    def _new_cell(self):  # pragma: no cover - overridden
        raise NotImplementedError

    def labels(self, **labelvalues: str):
        """The cell for one concrete label set (created on first use)."""
        if tuple(sorted(labelvalues)) != tuple(sorted(self.labelnames)):
            raise ValueError(
                f"{self.name}: labels {sorted(labelvalues)} do not match "
                f"declared labelnames {sorted(self.labelnames)}"
            )
        key = tuple(str(labelvalues[ln]) for ln in self.labelnames)
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = self._cells[key] = self._new_cell()
            return cell

    def _only_cell(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} declares labels {self.labelnames}; "
                "bind them with .labels(...) first"
            )
        return self._cells[()]

    def _cells_snapshot(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return list(self._cells.items())


class _CounterCell:
    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Counter(_Instrument):
    """Monotone event count (requests, episodes, watchdog trips)."""

    kind = "counter"

    def _new_cell(self):
        return _CounterCell()

    def inc(self, n: float = 1.0) -> None:
        self._only_cell().inc(n)

    @property
    def value(self) -> float:
        return self._only_cell().value


class _GaugeCell:
    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)
            self._fn = None

    def set_fn(self, fn: Callable[[], float]) -> None:
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        try:
            return float(fn())
        except Exception:
            # A dead callback (e.g. a stopped service) must not take the
            # whole scrape down; NaN marks it visibly.
            return float("nan")


class Gauge(_Instrument):
    """Point-in-time level (queue depth, occupancy, staleness)."""

    kind = "gauge"

    def _new_cell(self):
        return _GaugeCell()

    def set(self, v: float) -> None:
        self._only_cell().set(v)

    def set_fn(self, fn: Callable[[], float]) -> None:
        """Pull-time callback: evaluated at each snapshot/scrape."""
        self._only_cell().set_fn(fn)

    @property
    def value(self) -> float:
        return self._only_cell().value


class _HistogramCell:
    def __init__(self, window: int):
        self.window = PercentileWindow(window)

    def observe(self, v: float) -> None:
        self.window.add(v)

    # timed() calls .add — histograms drop in wherever a PercentileWindow did.
    add = observe

    def snapshot(self) -> Tuple[int, float, float, float]:
        """(count, total, p50, p99) under one window lock."""
        return self.window.snapshot()

    def percentiles(self, qs: Iterable[float] = (50.0, 99.0)):
        return self.window.percentiles(qs)

    @property
    def count(self) -> int:
        return self.window.count

    @property
    def total(self) -> float:
        return self.window.total

    def reset(self) -> None:
        self.window.reset()


class Histogram(_Instrument):
    """Sliding-window distribution; exported as a Prometheus summary."""

    kind = "histogram"

    def __init__(self, name, help, labelnames, *, window: int = 2048):
        self._window_size = window
        super().__init__(name, help, labelnames)

    def _new_cell(self):
        return _HistogramCell(self._window_size)

    def observe(self, v: float) -> None:
        self._only_cell().observe(v)

    add = observe

    def snapshot(self) -> Tuple[int, float, float, float]:
        return self._only_cell().snapshot()

    def percentiles(self, qs: Iterable[float] = (50.0, 99.0)):
        return self._only_cell().percentiles(qs)

    @property
    def count(self) -> int:
        return self._only_cell().count

    @property
    def total(self) -> float:
        return self._only_cell().total

    def reset(self) -> None:
        self._only_cell().reset()


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Registry:
    """Name -> instrument table with collision checking and snapshots."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, _Instrument] = {}

    # -------------------------------------------------------------- register
    def _register(self, cls, name: str, help: str, labelnames, **kw):
        labelnames = tuple(labelnames)
        with self._lock:
            existing = self._instruments.get(name)
            if existing is not None:
                window = kw.get("window")
                if (
                    type(existing) is not cls
                    or existing.labelnames != labelnames
                    or (
                        window is not None
                        and getattr(existing, "_window_size", window)
                        != window
                    )
                ):
                    raise ValueError(
                        f"instrument {name!r} already registered as "
                        f"{existing.kind}{existing.labelnames} (window="
                        f"{getattr(existing, '_window_size', None)}); "
                        f"cannot re-register as {cls.kind}{labelnames} "
                        f"with {kw or 'no kwargs'}"
                    )
                return existing
            inst = cls(name, help, labelnames, **kw)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, help: str = "", labelnames=()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames=()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(
        self, name: str, help: str = "", labelnames=(), *, window: int = 2048
    ) -> Histogram:
        return self._register(
            Histogram, name, help, labelnames, window=window
        )

    def get(self, name: str) -> Optional[_Instrument]:
        with self._lock:
            return self._instruments.get(name)

    def clear(self) -> None:
        """Drop every instrument (tests only — live objects keep working
        against their now-orphaned instruments)."""
        with self._lock:
            self._instruments.clear()

    def _items(self) -> List[_Instrument]:
        with self._lock:
            return list(self._instruments.values())

    # ------------------------------------------------------------- snapshots
    def snapshot(self) -> Dict[str, dict]:
        """JSON-able typed view: name -> {kind, help, samples: [...]}} where
        each sample is {labels: {...}, value | count/total/p50/p99}.

        Per-instrument isolation: one instrument whose cells raise at
        snapshot time (a ``set_fn`` gauge throwing something the NaN guard
        does not catch, a broken subclass) is reported as an entry with an
        ``error`` field and no samples — it must never take the other
        instruments (or the whole /metrics scrape) down with it."""
        out: Dict[str, dict] = {}
        for inst in self._items():
            try:
                samples = []
                for key, cell in inst._cells_snapshot():
                    labels = dict(zip(inst.labelnames, key))
                    if inst.kind == "histogram":
                        count, total, p50, p99 = cell.snapshot()
                        samples.append(
                            {
                                "labels": labels,
                                "count": count,
                                "total": total,
                                "p50": p50,
                                "p99": p99,
                            }
                        )
                    else:
                        samples.append({"labels": labels, "value": cell.value})
            except Exception as e:  # noqa: BLE001 - scrape isolation
                out[inst.name] = {
                    "kind": inst.kind,
                    "help": inst.help,
                    "error": f"{type(e).__name__}: {e}",
                    "samples": [],
                }
                continue
            out[inst.name] = {
                "kind": inst.kind,
                "help": inst.help,
                "samples": samples,
            }
        return out


_REGISTRY = Registry()


def get_registry() -> Registry:
    """THE process-wide default registry (module singleton)."""
    return _REGISTRY
