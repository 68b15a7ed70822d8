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
``_seconds`` for time histograms.  ``scalars()`` is the flat view the
``MetricLogger`` CSV bridge folds into its rows; ``render_prometheus`` is
the text exposition the exporter serves, with per-entry and per-sample
isolation (a broken instrument becomes a ``# ... omitted`` comment, and a
newline in a remote-supplied string cannot forge a line).

Federation: ``RemoteMirror`` holds other processes' snapshots under
attribution labels (``actor=``, ``shard=``), and ``merge_remote`` folds
them into one scrape, the attribution labels winning a collision.
``allgather_into_mirror`` feeds it on a multi-process run: every rank's
snapshot reaches rank 0 under ``host=proc<i>``.
"""

from __future__ import annotations

import math
import re
import threading
import time
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

    def scalars(self) -> Dict[str, float]:
        """Flat name -> float view — the MetricLogger CSV/TB bridge.

        Labelled samples flatten to ``name{a=x,b=y}``; histograms expand to
        ``name_count`` / ``name_total`` / ``name_p50`` / ``name_p99``."""
        out: Dict[str, float] = {}
        for name, entry in self.snapshot().items():
            for s in entry["samples"]:
                labels = s["labels"]
                suffix = (
                    "{" + ",".join(f"{k}={v}" for k, v in labels.items()) + "}"
                    if labels
                    else ""
                )
                if entry["kind"] == "histogram":
                    for field in ("count", "total", "p50", "p99"):
                        out[f"{name}{suffix}_{field}"] = float(s[field])
                else:
                    out[f"{name}{suffix}"] = float(s["value"])
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition (histograms as summaries)."""
        return render_prometheus(self.snapshot())


def render_prometheus(snapshot: Dict[str, dict]) -> str:
    """Snapshot dict -> Prometheus text exposition.

    Module-level so the exporter can render a MERGED snapshot (the local
    registry plus remote-mirror sources) with one TYPE line per family.

    Isolation (the one-bad-series contract): an entry carrying an
    ``error`` field, or one that fails to render outright, becomes a
    ``# <name> omitted: ...`` comment; a single malformed SAMPLE (a
    version-skewed remote snapshot merged into a healthy local family —
    a histogram sample missing ``p99``, a gauge-shaped sample under a
    histogram family) becomes a ``# <name> sample omitted: ...`` comment
    while the family's other samples — the learner's own local series
    included — still render.  The rest of the scrape is unaffected."""
    lines: List[str] = []
    for name, entry in snapshot.items():
        # Comments interpolate cname, never the raw (possibly
        # remote-supplied) name: a newline inside a name must not be able
        # to tear the exposition or forge series lines.
        cname = _one_line(str(name))
        try:
            if not _NAME_RE.match(str(name)):
                raise ValueError(f"invalid metric name {name!r}")
            if entry.get("error"):
                lines.append(f"# {cname} omitted: {_one_line(entry['error'])}")
                continue
            body: List[str] = []
            if entry.get("help"):
                body.append(f"# HELP {name} {_one_line(entry['help'])}")
            kind = entry.get("kind", "untyped")
            ptype = "summary" if kind == "histogram" else kind
            body.append(f"# TYPE {name} {ptype}")
            for s in entry.get("samples", ()):
                # Per-sample isolation, rendered all-or-nothing into a
                # scratch list so a mid-sample failure (p50 rendered, p99
                # missing) cannot leave a partial sample in the scrape.
                sample: List[str] = []
                try:
                    if s.get("error"):
                        # merge_remote's sentinel for a remote instrument
                        # that failed at snapshot time: an attributed,
                        # VISIBLE omission (the labels say who).
                        raise ValueError(
                            f"{_label_str(dict(s.get('labels') or {}))} "
                            f"{_one_line(s['error'])}"
                        )
                    labels = s.get("labels", {})
                    base = _label_str(labels)
                    if kind == "histogram":
                        for q, field in (("0.5", "p50"), ("0.99", "p99")):
                            sample.append(
                                f"{name}{_label_str({**labels, 'quantile': q})} "
                                f"{_fmt(s[field])}"
                            )
                        sample.append(f"{name}_count{base} {_fmt(s['count'])}")
                        sample.append(f"{name}_sum{base} {_fmt(s['total'])}")
                    else:
                        sample.append(f"{name}{base} {_fmt(s['value'])}")
                except Exception as e:  # noqa: BLE001 - scrape isolation
                    sample = [
                        f"# {cname} sample omitted: "
                        f"{type(e).__name__}: {_one_line(e)}"
                    ]
                body.extend(sample)
            lines.extend(body)
        except Exception as e:  # noqa: BLE001 - scrape isolation
            lines.append(
                f"# {cname} omitted: {type(e).__name__}: {_one_line(e)}"
            )
    return "\n".join(lines) + "\n"


def _one_line(v) -> str:
    return " ".join(str(v).split())


def _label_str(labels: Dict[str, str]) -> str:
    """Exposition label block.  Values get the exposition-format escapes
    (backslash, quote, AND newline — a remote-supplied value must not be
    able to tear the scrape into forged lines); a label NAME that fails
    the name regex raises, which the renderer's per-sample isolation
    turns into a visible sample-omitted comment."""
    if not labels:
        return ""
    parts = []
    for k, v in labels.items():
        if not _NAME_RE.match(str(k)):
            raise ValueError(f"invalid label name {k!r}")
        parts.append(
            '{}="{}"'.format(
                k,
                str(v)
                .replace("\\", "\\\\")
                .replace('"', '\\"')
                .replace("\n", "\\n"),
            )
        )
    return "{" + ",".join(parts) + "}"


def _fmt(v) -> str:
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f) if not f.is_integer() else str(int(f))


_REGISTRY = Registry()


def get_registry() -> Registry:
    """THE process-wide default registry (module singleton)."""
    return _REGISTRY


# --------------------------------------------------------------- federation
class RemoteMirror:
    """Other processes' registry snapshots, held for merged scrapes.

    The fleet-wide scrape point: each remote process (a fleet actor or a
    shard process pushing TELEM snapshots) contributes its
    ``Registry.snapshot()`` plus attribution labels (``actor=<id>``,
    ``host=<name>``); the exporter merges them with the local registry so
    ONE ``/metrics`` page carries every process's series.

    Sources are keyed (``actor:0``, ``proc:1``): a reconnecting actor
    UPDATES its slot instead of growing a new one, so re-registration is
    idempotent by construction.  A dead source's snapshot stays at its
    last values — staleness is surfaced by the per-source age here and by
    the ingest server's per-actor staleness gauges, never by the series
    silently freezing without a marker."""

    def __init__(self):
        self._lock = threading.Lock()
        # key -> (labels, snapshot, t_mono of last update)
        self._sources: Dict[str, Tuple[Dict[str, str], Dict, float]] = {}

    def update(self, key: str, labels: Dict[str, str], snapshot: Dict) -> None:
        if not isinstance(snapshot, dict):
            raise TypeError(
                f"remote snapshot must be a dict, got {type(snapshot).__name__}"
            )
        with self._lock:
            self._sources[key] = (
                {str(k): str(v) for k, v in labels.items()},
                snapshot,
                time.monotonic(),
            )

    def drop(self, key: str) -> None:
        with self._lock:
            self._sources.pop(key, None)

    def clear(self) -> None:
        with self._lock:
            self._sources.clear()

    def sources(self) -> List[Tuple[str, Dict[str, str], Dict]]:
        with self._lock:
            return [
                (k, dict(labels), snap)
                for k, (labels, snap, _) in self._sources.items()
            ]

    def staleness_s(self, key: str) -> Optional[float]:
        """Seconds since this source's last update (None if unknown)."""
        with self._lock:
            entry = self._sources.get(key)
        return None if entry is None else time.monotonic() - entry[2]


def merge_remote(
    base: Dict[str, dict],
    sources: Iterable[Tuple[str, Dict[str, str], Dict]],
) -> Dict[str, dict]:
    """Fold remote snapshots into a base snapshot for one merged scrape.

    Remote samples get the source's attribution labels merged OVER their
    own (the federation convention: the aggregator's external labels win a
    collision — they say WHO reported).  Families merge by name, the base
    entry's kind/help winning, so the rendered text keeps one TYPE line
    per family.  Malformed remote entries are skipped per-family (the
    renderer additionally isolates per-entry)."""
    out = dict(base)
    for _key, labels, snap in sources:
        if not isinstance(snap, dict):
            continue
        for name, entry in snap.items():
            if not isinstance(entry, dict):
                continue
            raw = entry.get("samples", ())
            if not isinstance(raw, (list, tuple)):
                continue
            samples = []
            err = entry.get("error")
            if err:
                # A remote instrument that failed at SNAPSHOT time (the
                # per-instrument isolation path of Registry.snapshot):
                # forward the error as a sentinel SAMPLE, not a
                # family-level error — family-level would omit other
                # sources' healthy series sharing the name — so the
                # renderer emits an attributed "# ... sample omitted"
                # comment instead of the series silently vanishing.
                samples.append({"labels": dict(labels), "error": str(err)})
            for s in raw:
                if not isinstance(s, dict):
                    continue
                own = s.get("labels", {})
                own = own if isinstance(own, dict) else {}
                samples.append({**s, "labels": {**own, **labels}})
            existing = out.get(name)
            if existing is None:
                out[name] = {
                    "kind": entry.get("kind", "gauge"),
                    "help": entry.get("help", ""),
                    "samples": samples,
                }
            else:
                out[name] = {
                    **existing,
                    "samples": list(existing.get("samples", ())) + samples,
                }
    return out


_MIRROR = RemoteMirror()


def get_remote_mirror() -> RemoteMirror:
    """THE process-wide remote mirror (module singleton; empty until
    something feeds it)."""
    return _MIRROR


def allgather_into_mirror(
    registry: Optional[Registry] = None,
    mirror: Optional[RemoteMirror] = None,
) -> int:
    """Every rank's registry snapshot into rank 0's mirror.

    COLLECTIVE: every process of the ``torch.distributed`` group calls it
    at the same point (``train.py``: the log cadence under ``--obs-fleet``).
    Fixed-shape collectives: an ``all_gather`` of the payload lengths, then
    one of the JSON payloads padded to the widest, as uint8.  Rank 0 folds
    each other rank under ``host=proc<i>`` (a torn payload is skipped).
    Returns the number of snapshots folded: 0 on a world of one (or with
    no group) and on every rank but 0."""
    import json

    import torch
    import torch.distributed as dist

    registry = registry if registry is not None else get_registry()
    mirror = mirror if mirror is not None else get_remote_mirror()
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    n = dist.get_world_size()
    if n == 1:
        return 0
    # NCCL moves card tensors only; gloo host tensors.
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    payload = torch.frombuffer(
        bytearray(json.dumps(registry.snapshot()).encode()), dtype=torch.uint8
    ).to(device)
    lens = torch.empty(n, dtype=torch.int64, device=device)
    dist.all_gather_into_tensor(
        lens, torch.tensor([payload.numel()], dtype=torch.int64, device=device))
    lens = lens.tolist()
    width = max(lens)
    padded = torch.zeros(width, dtype=torch.uint8, device=device)
    padded[: payload.numel()] = payload
    gathered = torch.empty(n * width, dtype=torch.uint8, device=device)
    dist.all_gather_into_tensor(gathered, padded)
    me = dist.get_rank()
    if me != 0:
        return 0
    rows = gathered.view(n, width).cpu().numpy()
    folded = 0
    for i in range(n):
        if i == me:
            continue  # rank 0's own registry is already exported
        try:
            snap = json.loads(bytes(rows[i, : lens[i]]).decode())
        except ValueError:
            continue  # a torn rank must not kill the aggregate scrape
        mirror.update(f"proc:{i}", {"host": f"proc{i}"}, snap)
        folded += 1
    return folded
