"""Flight recorder: a bounded ring of structured events for post-mortems.

Port of the event ring of ``r2d2dpg_tpu/obs/flight.py``.  Subsystems drop
small structured events into a process-wide ring
(``flight_event(kind, **fields)``): the serving stack's ``shed``,
``hot_reload``, ``ttl_eviction`` and ``worker_error``, the checkpoint
manager's ``checkpoint_save``.  The ring is bounded (old events fall off),
recording is a deque append under a lock, and nothing touches the disk
until a dump: at interpreter exit once ``install`` armed it, or on demand.

A dump is JSONL (one event per line, oldest first), written to a temporary
file and renamed, so a crash mid-dump never leaves a torn file.  Each event
carries::

    {"kind": ..., "t_wall": <unix seconds>, "t_mono": <monotonic seconds>,
     "seq": <monotone index>, "thread": <recording thread name>,
     "pid": <os pid>, ...fields}

``install`` also points ``faulthandler`` at ``<path>.fault``, so a native
crash's traceback lands beside the last dump.  The span ring, its
Chrome-trace dump and the ``merge`` CLI come with the telemetry slice.
"""

from __future__ import annotations

import atexit
import faulthandler
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional


class FlightRecorder:
    """Bounded in-memory event ring + atomic JSONL dumps."""

    def __init__(self, capacity: int = 512):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self._seq = 0
        self._installed_path: Optional[str] = None
        self._fault_file = None

    def record(self, kind: str, **fields) -> None:
        event = {
            "kind": str(kind),
            "t_wall": time.time(),
            "t_mono": time.monotonic(),
            "thread": threading.current_thread().name,
            "pid": os.getpid(),
        }
        with self._lock:
            event.update(fields)
            event["seq"] = self._seq
            self._seq += 1
            self._ring.append(event)

    def events(self) -> List[Dict]:
        with self._lock:
            return list(self._ring)

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

    def install(self, path: str) -> None:
        """Arm exit-time capture: dump to ``path`` at interpreter exit and
        route hard-crash native tracebacks to ``<path>.fault``.

        Idempotent per path; installing again with a new path re-targets
        the dump (one atexit hook either way).
        """
        with self._lock:
            first = self._installed_path is None
            self._installed_path = path
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
