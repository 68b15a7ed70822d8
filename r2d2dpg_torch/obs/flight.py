"""Flight recorder: a bounded ring of structured events for post-mortems.

Port of ``r2d2dpg_tpu/obs/flight.py``.  Subsystems drop
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
``flight.jsonl``; a recorder with no spans writes no file.  A shard
process installs with ``trace_format="jsonl"`` and dumps its raw span
lines as ``trace_shard<i>.jsonl`` instead.

**Merge CLI**::

    python -m r2d2dpg_torch.obs.flight merge <dir|file>... [-o OUT] [--trace-out T]

concatenates every process's ``flight*.jsonl`` into one ``t_wall``-ordered
timeline (each event stamped with its ``file``); ``--trace-out`` also fuses
every span dump it finds (``trace*.json`` Chrome documents and
``trace*.jsonl`` raw rings) into one Perfetto timeline, with each
``profile_start``/``profile_stop`` pair of the device plane's
``--profile-window`` as a labelled ``profile_window`` span.
"""

from __future__ import annotations

import atexit
import faulthandler
import glob
import json
import os
import sys
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple


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
        self._trace_format = "chrome"
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

    @property
    def recorded_total(self) -> int:
        """Events ever recorded (at least ``len(events())`` once the ring
        wrapped)."""
        with self._lock:
            return self._seq

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

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
        """Write the span ring (atomic): Chrome-trace JSON, or raw span
        JSONL when installed with ``trace_format="jsonl"``.  Returns the
        path, or None when no path is known or no span was recorded."""
        path = path or self._trace_path
        spans = self.spans()
        if path is None or not spans:
            return None
        if self._trace_format == "jsonl":
            _atomic_write(
                path, "".join(json.dumps(s, default=str) + "\n" for s in spans))
        else:
            _atomic_write(path, json.dumps(chrome_trace(spans), default=str))
        return path

    def install(
        self,
        path: str,
        *,
        trace_path: Optional[str] = None,
        trace_format: str = "chrome",
    ) -> None:
        """Arm exit-time capture: dump events to ``path`` and spans to
        ``trace_path`` at interpreter exit, and route hard-crash native
        tracebacks to ``<path>.fault``.

        ``trace_path`` defaults to ``path``'s directory and name with its
        ``flight`` prefix swapped for ``trace`` and ``.json`` for the
        suffix: ``flight.jsonl`` -> ``trace.json``.  ``trace_format="jsonl"``
        dumps raw span lines instead of a Chrome document (the shard
        processes' ``trace_shard<i>.jsonl``, which the merge CLI folds).
        Idempotent per path; installing again with a new path re-targets
        the dumps (one atexit hook either way).
        """
        if trace_format not in ("chrome", "jsonl"):
            raise ValueError(f"unknown trace_format {trace_format!r}")
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
            self._trace_format = trace_format
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


# ----------------------------------------------------------------- merge CLI
def expand_flight_paths(paths: Iterable[str]) -> List[str]:
    """Resolve the merge CLI's arguments: files pass through, directories
    expand to their ``flight*.jsonl`` dumps — the learner's
    ``flight.jsonl``, per-actor ``flight_actorN.jsonl``, and per-shard-
    proc ``flight_shardN.jsonl`` all match one pattern, so a run DIR is
    a complete argument on its own."""
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(glob.glob(os.path.join(p, "flight*.jsonl"))))
        else:
            out.append(p)
    return out


def expand_trace_paths(paths: Iterable[str]) -> List[str]:
    """The span-source half of run-dir discovery: directories expand to
    their ``trace*.jsonl`` span dumps (shard procs) AND ``trace*.json``
    Chrome documents (the learner's dump_trace artifact); explicit files
    pass through.  Both formats feed ``load_spans``."""
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(
                sorted(
                    glob.glob(os.path.join(p, "trace*.jsonl"))
                    + glob.glob(os.path.join(p, "trace*.json"))
                )
            )
        else:
            out.append(p)
    return out


# Top-level marker stamped into every --trace-out document (Perfetto
# ignores unknown keys): distinguishes a previous merge output — safe to
# exclude from span discovery and overwrite on a re-run — from a process's
# real span dump, which must never be silently clobbered.
_FUSED_KEY = "fusedBy"


def _is_trace_arg(path: str) -> bool:
    """Classify a non-directory merge argument by NAME: ``trace*.jsonl``
    and ``trace*.json`` are span dumps for the ``--trace-out`` fuse, never
    event-timeline sources — a span line parses as a valid JSON dict (it
    even carries ``t_wall``), so feeding one to ``merge_flight_files``
    would silently interleave bogus no-``kind`` events into the fleet
    timeline instead of failing."""
    name = os.path.basename(path)
    return name.startswith("trace") and (
        name.endswith(".jsonl") or name.endswith(".json")
    )


def _span_from_chrome_event(e: Dict) -> Optional[Dict]:
    """Invert ``chrome_trace``'s event shape back into a raw span so an
    already-rendered learner ``trace.json`` merges with the shard procs'
    raw ``trace_shard*.jsonl`` rings on equal footing."""
    if not isinstance(e, dict) or e.get("ph") != "X":
        return None
    args = e.get("args") if isinstance(e.get("args"), dict) else {}
    try:
        span = {
            "hop": str(e.get("name", "span")),
            "trace_id": int(args.get("trace_id", e.get("tid", 0))),
            "t_wall": float(e.get("ts", 0.0)) / 1e6,
            "dur_s": float(e.get("dur", 0.0)) / 1e6,
            "pid": int(e.get("pid", 0)),
        }
    except (TypeError, ValueError):
        # A non-numeric ts/dur/tid (truncated, foreign, or version-skewed
        # dump) is one bad EVENT: None -> the caller's skipped tally,
        # like any other unparseable line — never a merge-wide traceback.
        return None
    span.update({k: v for k, v in args.items() if k != "trace_id"})
    return span


def load_spans(paths: Iterable[str]) -> Tuple[List[Dict], int]:
    """N span dumps (raw ``.jsonl`` lines and/or Chrome ``.json``
    documents) -> one span list + the count of unparseable lines/events.
    Every span gets a ``file`` source stamp (preserved over a merge, like
    the event timeline's), so the fused Perfetto view still says which
    process recorded each hop."""
    spans: List[Dict] = []
    skipped = 0
    for path in paths:
        name = os.path.basename(path)
        try:
            with open(path) as f:
                content = f.read()
        except OSError:
            skipped += 1
            continue
        if path.endswith(".jsonl"):
            for line in content.splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    s = json.loads(line)
                except ValueError:
                    skipped += 1
                    continue
                if isinstance(s, dict) and "hop" in s:
                    s.setdefault("file", name)
                    spans.append(s)
                else:
                    skipped += 1
        else:
            try:
                doc = json.loads(content)
            except ValueError:
                skipped += 1
                continue
            if isinstance(doc, dict) and _FUSED_KEY in doc:
                # A previous merge output (any name): derived data, never
                # a source — re-ingesting it would duplicate every span
                # it fused, N+1 copies after N re-runs into one run dir.
                continue
            events = (
                doc.get("traceEvents", ()) if isinstance(doc, dict) else ()
            )
            for e in events:
                s = _span_from_chrome_event(e)
                if s is None:
                    skipped += 1
                    continue
                s.setdefault("file", name)
                spans.append(s)
    return sort_by_twall(spans), skipped


def profile_window_spans(events: Iterable[Dict]) -> List[Dict]:
    """Pair ``profile_start``/``profile_stop`` flight events (the device
    plane's ``--profile-window`` capture brackets, obs/device.py) into
    labelled ``profile_window`` spans for the fused Perfetto timeline —
    the capture window is visible IN the timeline it profiles, so "which
    phases does this trace cover" is answered by the evidence itself.

    Pairing is per (file, pid): each process's own start matches its own
    stop; an unmatched start (the run died mid-capture) still yields a
    zero-duration marker span so the attempt is never invisible."""
    spans: List[Dict] = []
    open_starts: Dict[Tuple, Dict] = {}
    for e in sort_by_twall(events):
        if not isinstance(e, dict):
            continue
        key = (e.get("file"), e.get("pid"))
        if e.get("kind") == "profile_start":
            open_starts[key] = e
        elif e.get("kind") == "profile_stop":
            s = open_starts.pop(key, None)
            if s is None:
                continue
            spans.append(
                {
                    "hop": "profile_window",
                    "trace_id": 0,
                    "t_wall": float(s.get("t_wall", 0.0)),
                    "dur_s": max(
                        float(e.get("t_wall", 0.0))
                        - float(s.get("t_wall", 0.0)),
                        0.0,
                    ),
                    "pid": int(e.get("pid", 0) or 0),
                    "file": e.get("file"),
                    "phase": s.get("phase"),
                    "logdir": s.get("logdir"),
                }
            )
    for key, s in open_starts.items():
        spans.append(
            {
                "hop": "profile_window",
                "trace_id": 0,
                "t_wall": float(s.get("t_wall", 0.0)),
                "dur_s": 0.0,
                "pid": int(s.get("pid", 0) or 0),
                "file": s.get("file"),
                "phase": s.get("phase"),
                "unterminated": True,
            }
        )
    return spans


def merge_flight_files(paths: Iterable[str]) -> Tuple[List[Dict], int]:
    """N processes' flight dumps -> one ``t_wall``-ordered fleet timeline,
    plus the count of lines that could not be parsed.

    Each event is stamped with its source file (``file``) on top of the
    identity fields it already carries; unparseable lines are skipped and
    COUNTED rather than aborting a post-mortem over one torn line — the
    CLI reports the count so a truncated timeline is never mistaken for a
    complete one."""
    events: List[Dict] = []
    skipped = 0
    for path in paths:
        name = os.path.basename(path)
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    e = json.loads(line)
                except ValueError:
                    skipped += 1
                    continue
                if isinstance(e, dict):
                    e.setdefault("file", name)
                    events.append(e)
                else:
                    skipped += 1
    return sort_by_twall(events), skipped


def main(argv=None) -> None:
    """``python -m r2d2dpg_torch.obs.flight merge <dir|file>... [-o OUT]``"""
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m r2d2dpg_torch.obs.flight",
        description="flight-recorder tooling",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    m = sub.add_parser(
        "merge",
        help="interleave N processes' flight*.jsonl dumps by t_wall into "
        "one attributable fleet timeline",
    )
    m.add_argument(
        "paths", nargs="+",
        help="flight .jsonl files, trace*.jsonl/trace*.json span dumps "
        "(--trace-out sources), and/or run dirs (dirs expand to both "
        "kinds)",
    )
    m.add_argument(
        "-o", "--out", default=None,
        help="write the merged JSONL here (default: stdout)",
    )
    m.add_argument(
        "--trace-out", default=None, metavar="TRACE_JSON",
        help="also fuse every discovered span dump (the learner's "
        "trace.json + the shard procs' trace_shard*.jsonl rings) into "
        "ONE Perfetto/chrome://tracing timeline at this path",
    )
    args = p.parse_args(argv)
    # Explicit trace* file args are span sources, never timeline sources
    # (see _is_trace_arg); naming one without --trace-out is a request
    # the event merge cannot honor — refuse instead of ignoring it.
    span_args = [
        q for q in args.paths if not os.path.isdir(q) and _is_trace_arg(q)
    ]
    if span_args and not args.trace_out:
        raise SystemExit(
            "flight merge: trace dump args "
            f"({', '.join(os.path.basename(q) for q in span_args)}) are "
            "span sources — pass --trace-out to fuse them"
        )
    paths = expand_flight_paths(
        [q for q in args.paths if q not in span_args]
    )
    if not paths and not args.trace_out:
        raise SystemExit("flight merge: no flight*.jsonl files found")
    # ONE event merge feeds both consumers — the -o/stdout timeline AND
    # the --trace-out profile-window pairing below (re-reading megabytes
    # of flight lines per consumer would be pure waste); it is skipped
    # entirely only when nothing consumes events (no paths, or a
    # --trace-out-without--o run on a dir with no flight dumps).
    merged: List[Dict] = []
    skipped = 0
    if paths:
        merged, skipped = merge_flight_files(paths)
    if paths and (args.out or args.trace_out is None):
        body = "".join(json.dumps(e, default=str) + "\n" for e in merged)
        skip_note = (
            f" ({skipped} unparseable lines skipped)" if skipped else ""
        )
        if args.out:
            _atomic_write(args.out, body)
            sys.stderr.write(
                f"flight merge: {len(merged)} events from {len(paths)} files"
                f"{skip_note} -> {args.out}\n"
            )
        else:
            sys.stdout.write(body)
            if skip_note:
                sys.stderr.write(f"flight merge:{skip_note}\n")
    if args.trace_out:
        # Span sources: every directory arg's trace*.jsonl / trace*.json
        # dumps plus the explicitly-named ones — minus the --trace-out
        # target itself (writing the fused doc INTO a scanned run dir is
        # natural, and a re-run would otherwise re-ingest the previous
        # output and duplicate every span).  The exclusion is only safe
        # when the target IS a previous fused output (the _FUSED_KEY
        # marker below): an existing trace* file WITHOUT the marker is a
        # real span dump (e.g. the learner's trace.json), and
        # exclude+overwrite would drop its spans from the fusion AND
        # destroy them on disk — refuse instead.
        out_abs = os.path.abspath(args.trace_out)
        if os.path.isfile(out_abs) and _is_trace_arg(out_abs):
            try:
                with open(out_abs) as f:
                    prev = json.load(f)
                prev_fused = isinstance(prev, dict) and _FUSED_KEY in prev
            except (OSError, ValueError):
                prev_fused = False
            if not prev_fused:
                raise SystemExit(
                    f"flight merge: --trace-out {args.trace_out} would "
                    "overwrite an existing span dump (not a previous "
                    "merge output) — pick a different output name"
                )
        trace_paths = []
        seen_abs = {out_abs}
        for q in (
            expand_trace_paths([q for q in args.paths if os.path.isdir(q)])
            + span_args
        ):
            # abspath-dedup: a dump named BOTH explicitly and via its
            # containing run-dir arg must feed the fusion once, not
            # twice (duplicate X events per Perfetto lane).
            q_abs = os.path.abspath(q)
            if q_abs in seen_abs:
                continue
            seen_abs.add(q_abs)
            trace_paths.append(q)
        spans, tskipped = load_spans(trace_paths)
        if merged:
            # Profiler capture windows (obs/device.py --profile-window):
            # the start/stop flight events become labelled profile_window
            # spans, so the fused timeline shows WHICH phases the
            # profiler dump under <logdir>/profile_window covers.
            spans = sort_by_twall(spans + profile_window_spans(merged))
        if not spans:
            raise SystemExit(
                "flight merge: --trace-out found no spans (no "
                "trace*.jsonl / trace*.json among the given dirs/files — "
                "was the run traced? --trace-sample 0 records nothing)"
            )
        doc = chrome_trace(spans)
        doc[_FUSED_KEY] = "python -m r2d2dpg_torch.obs.flight merge"
        _atomic_write(args.trace_out, json.dumps(doc, default=str))
        tnote = f" ({tskipped} unparseable skipped)" if tskipped else ""
        sys.stderr.write(
            f"flight merge: {len(spans)} spans from {len(trace_paths)} "
            f"trace dumps{tnote} -> {args.trace_out}\n"
        )


if __name__ == "__main__":
    main()
