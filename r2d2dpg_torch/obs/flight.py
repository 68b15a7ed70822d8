"""Flight recorder: a bounded ring of structured events for post-mortems.

Port of the event ring of ``r2d2dpg_tpu/obs/flight.py``.  Subsystems drop
small structured events into a process-wide ring
(``flight_event(kind, **fields)``): the serving stack's ``shed``,
``hot_reload``, ``ttl_eviction`` and ``worker_error``, the checkpoint
manager's ``checkpoint_save``.  The ring is bounded (old events fall off),
recording is a deque append under a lock, and nothing touches the disk
until a dump: at interpreter exit once ``install`` armed it, or on demand.

``set_flight_identity(**fields)`` stamps who-is-recording fields (a fleet
actor's ``actor`` id) onto every later event and span, so the dumps of a
fleet's processes stay attributable when read side by side.

A dump is JSONL (one event per line, oldest first), written to a temporary
file and renamed, so a crash mid-dump never leaves a torn file.  Each event
carries::

    {"kind": ..., "t_wall": <unix seconds>, "t_mono": <monotonic seconds>,
     "seq": <monotone index>, "thread": <recording thread name>,
     "pid": <os pid>, ...fields}

``install`` also points ``faulthandler`` at ``<path>.fault``, so a native
crash's traceback lands beside the last dump.

**Span ring** (the rest of the JAX module's recorder): beside the event
ring a second bounded ring (2,048 spans) holds experience-path spans,
``record_span(hop, trace_id, t_wall, dur_s, **attrs)``, fed by
``obs/trace.py``'s sampled hop recorder.  ``dump_trace`` writes them as a
Chrome-trace/Perfetto ``trace.json`` (atomic, like ``dump``) next to
``flight.jsonl``; a recorder with no spans writes no file.  The ``merge``
CLI and the dump loaders come with the rest of telemetry.
"""

from __future__ import annotations

import atexit
import faulthandler
import json
import os
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional


def sort_by_twall(events: Iterable[Dict]) -> List[Dict]:
    """Stable sort on wall-clock seconds (the trace dumper's order)."""
    return sorted(events, key=lambda e: float(e.get("t_wall", 0.0)))


def chrome_trace(spans: Iterable[Dict]) -> Dict:
    """Spans -> a Chrome Trace Event Format document (Perfetto loads it).

    Each span becomes one complete event (``ph: "X"``): rows group by the
    recording pid, and ``tid`` is the trace id (one lane per sampled
    batch), so a batch's hops read left to right."""
    events = []
    for s in sort_by_twall(spans):
        args = {
            k: v
            for k, v in s.items()
            if k not in ("hop", "t_wall", "dur_s", "pid", "trace_id")
        }
        args["trace_id"] = s.get("trace_id", 0)
        events.append(
            {
                "name": str(s.get("hop", "span")),
                "cat": "experience",
                "ph": "X",
                "ts": float(s.get("t_wall", 0.0)) * 1e6,
                "dur": max(float(s.get("dur_s", 0.0)), 0.0) * 1e6,
                "pid": int(s.get("pid", 0)),
                "tid": int(s.get("trace_id", 0)) & 0x7FFFFFFF,
                "args": args,
            }
        )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


class FlightRecorder:
    """Bounded in-memory event and span rings + atomic JSONL/trace dumps."""

    def __init__(self, capacity: int = 512, span_capacity: int = 2048):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self._spans: deque = deque(maxlen=max(span_capacity, 1))
        self._seq = 0
        self._installed_path: Optional[str] = None
        self._trace_path: Optional[str] = None
        self._fault_file = None
        self._identity: Dict[str, object] = {}

    def set_identity(self, **fields) -> None:
        """Stamp who-is-recording fields onto every later event and span.
        Merges: a later call adds or overwrites keys, dropping none."""
        with self._lock:
            self._identity.update(fields)

    def record(self, kind: str, **fields) -> None:
        event = {
            "kind": str(kind),
            "t_wall": time.time(),
            "t_mono": time.monotonic(),
            "thread": threading.current_thread().name,
            "pid": os.getpid(),
        }
        with self._lock:
            event.update(self._identity)
            event.update(fields)  # explicit fields win over the identity
            event["seq"] = self._seq
            self._seq += 1
            self._ring.append(event)

    def events(self) -> List[Dict]:
        with self._lock:
            return list(self._ring)

    # ----------------------------------------------------------------- spans
    def record_span(
        self, hop: str, trace_id: int, t_wall: float, dur_s: float, **attrs
    ) -> None:
        """One hop of one sampled batch (``obs/trace.py`` records; this
        stores): a deque append under the lock, as ``record``."""
        span = {
            "hop": str(hop),
            "trace_id": int(trace_id),
            "t_wall": float(t_wall),
            "dur_s": float(dur_s),
            "pid": os.getpid(),
        }
        with self._lock:
            span.update(self._identity)
            span.update({k: v for k, v in attrs.items() if v is not None})
            self._spans.append(span)

    def spans(self) -> List[Dict]:
        with self._lock:
            return list(self._spans)

    def clear_spans(self) -> None:
        with self._lock:
            self._spans.clear()

    # ------------------------------------------------------------------ dump
    def dump(self, path: Optional[str] = None) -> Optional[str]:
        """Write the ring as JSONL (atomic tmp+rename).  Returns the path,
        or None when neither ``path`` nor an installed path exists."""
        path = path or self._installed_path
        if path is None:
            return None
        events = self.events()
        _atomic_write(
            path, "".join(json.dumps(e, default=str) + "\n" for e in events)
        )
        return path

    def dump_trace(self, path: Optional[str] = None) -> Optional[str]:
        """Write the span ring as Chrome-trace JSON (atomic).  Returns the
        path, or None when no path is known or no span was recorded."""
        path = path or self._trace_path
        spans = self.spans()
        if path is None or not spans:
            return None
        _atomic_write(path, json.dumps(chrome_trace(spans), default=str))
        return path

    def install(self, path: str, *, trace_path: Optional[str] = None) -> None:
        """Arm exit-time capture: dump events to ``path`` and spans to
        ``trace_path`` at interpreter exit, and route hard-crash native
        tracebacks to ``<path>.fault``.

        ``trace_path`` defaults to ``path``'s directory and name with its
        ``flight`` prefix swapped for ``trace`` and ``.json`` for the
        suffix: ``flight.jsonl`` -> ``trace.json``.  Idempotent per path;
        installing again with a new path re-targets the dumps (one atexit
        hook either way).
        """
        if trace_path is None:
            base = os.path.basename(path)
            root = base[: -len(".jsonl")] if base.endswith(".jsonl") else (
                os.path.splitext(base)[0]
            )
            name = (
                "trace" + root[len("flight"):]
                if root.startswith("flight")
                else f"trace_{root}"
            ) + ".json"
            trace_path = os.path.join(os.path.dirname(os.path.abspath(path)), name)
        with self._lock:
            first = self._installed_path is None
            self._installed_path = path
            self._trace_path = trace_path
        if first:
            atexit.register(self._atexit_dump)
        try:
            fault = open(f"{path}.fault", "w")
            faulthandler.enable(file=fault)
            old, self._fault_file = self._fault_file, fault
            if old is not None:
                old.close()
        except OSError:
            pass  # unwritable dir: the ring (and atexit dump) still work

    def _atexit_dump(self) -> None:
        try:
            self.dump()
            self.dump_trace()
        except OSError:
            pass  # exit-time best effort: never turn teardown into a crash


def _atomic_write(path: str, content: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(content)
    os.replace(tmp, path)


_RECORDER = FlightRecorder()


def get_flight_recorder() -> FlightRecorder:
    """THE process-wide flight recorder (module singleton)."""
    return _RECORDER


def flight_event(kind: str, **fields) -> None:
    """Record one event into the process recorder (the library-side API)."""
    _RECORDER.record(kind, **fields)


def set_flight_identity(**fields) -> None:
    """Stamp identity fields (``actor``, ...) onto every later event and
    span of the process recorder (``FlightRecorder.set_identity``)."""
    _RECORDER.set_identity(**fields)
