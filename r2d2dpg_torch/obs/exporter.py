"""Pull exporter: a stdlib-HTTP background thread serving the registry.

Port of ``r2d2dpg_tpu/obs/exporter.py``.  One scrape point per process:

- ``GET /metrics``       Prometheus text exposition (histograms as
                         summaries);
- ``GET /metrics.json``  the registry's typed JSON snapshot (alias
                         ``/snapshot``);
- ``GET /health``        the ``HealthEngine`` verdict JSON, always HTTP 200
                         (a degraded run is an answer, not a transport
                         error);
- ``GET /healthz``       ``ok`` (liveness only);
- anything else          404.

The exporter merges a ``RemoteMirror`` (other processes' snapshots under
attribution labels) with the local registry.  A scrape never 500s because
one instrument is broken: isolation lives in ``Registry.snapshot`` and
``render_prometheus``; the handler's outer guard turns whatever still
escapes into a plain 500 without killing the server thread.

The server thread is a daemon; ``start_exporter`` is a process singleton
(the train and serve CLIs call it with ``--obs-port``; 0 binds an
ephemeral port, resolved on ``exporter.port``).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from r2d2dpg_torch.obs.health import HealthEngine
from r2d2dpg_torch.obs.registry import (
    Registry,
    RemoteMirror,
    get_registry,
    get_remote_mirror,
    merge_remote,
    render_prometheus,
)
from r2d2dpg_torch.utils.profiling import enable_spans


class MetricsExporter:
    """Serve one registry (+ optional remote mirror) over HTTP until
    ``stop()`` (or process exit).

    ``health`` is the /health verdict engine; a caller that learns its
    topology AFTER the exporter starts (train.py resolves
    --actors/--shard-procs later) re-arms it with thresholds and
    expected process counts via ``arm_health()`` — a GET with no engine
    armed lazily builds a default one over this exporter's
    registry+mirror.  Both paths share one lock: the server is already
    serving when the caller arms, and an unguarded lazy default could
    otherwise win a check-then-act race and silently replace the
    configured engine (default thresholds disarm actors_down/
    shards_down) for the rest of the run."""

    def __init__(
        self,
        registry: Registry,
        port: int = 0,
        host: str = "0.0.0.0",
        mirror: Optional[RemoteMirror] = None,
        health: Optional[HealthEngine] = None,
    ):
        self.registry = registry
        self.mirror = mirror
        self.health = health
        self._health_lock = threading.Lock()
        exporter = self

        def merged_snapshot():
            snap = exporter.registry.snapshot()
            if exporter.mirror is not None:
                sources = exporter.mirror.sources()
                if sources:
                    snap = merge_remote(snap, sources)
            return snap

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - http.server API
                path = self.path.split("?")[0]
                try:
                    if path == "/metrics":
                        body = render_prometheus(merged_snapshot()).encode()
                        ctype = "text/plain; version=0.0.4; charset=utf-8"
                    elif path in ("/metrics.json", "/snapshot"):
                        body = json.dumps(
                            merged_snapshot(), default=str
                        ).encode()
                        ctype = "application/json"
                    elif path == "/health":
                        engine = exporter.health
                        if engine is None:
                            # Lazy default: verdicts over whatever this
                            # process's registry+mirror already carry
                            # (thresholds at HealthConfig defaults).
                            # Re-checked under the arm_health lock so a
                            # concurrently-armed configured engine is
                            # never replaced by the default.
                            with exporter._health_lock:
                                if exporter.health is None:
                                    exporter.health = HealthEngine(
                                        registry=exporter.registry,
                                        mirror=exporter.mirror,
                                    )
                                engine = exporter.health
                        body = json.dumps(
                            engine.evaluate(), default=str
                        ).encode()
                        ctype = "application/json"
                    elif path == "/healthz":
                        body, ctype = b"ok\n", "text/plain"
                    else:
                        self.send_error(404)
                        return
                except Exception as e:  # noqa: BLE001 - never kill the thread
                    # Last-resort guard (per-series isolation already lives
                    # in snapshot/render): a plain 500, server still alive.
                    try:
                        self.send_error(
                            500, f"scrape failed: {type(e).__name__}"
                        )
                    except OSError:
                        pass
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence per-request stderr spam
                pass

        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="obs-exporter",
            daemon=True,
        )
        self._thread.start()

    def arm_health(self, engine: HealthEngine) -> HealthEngine:
        """Install the configured verdict engine (lock-shared with the
        /health handler's lazy default, which must never outrace it)."""
        with self._health_lock:
            self.health = engine
        return engine

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)


_lock = threading.Lock()
_exporter: Optional[MetricsExporter] = None


def start_exporter(
    port: int = 0,
    registry: Optional[Registry] = None,
    host: str = "0.0.0.0",
    mirror: Optional[RemoteMirror] = None,
) -> MetricsExporter:
    """Start (or return) THE process exporter.

    A second call while one is running returns the existing exporter —
    one process, one scrape point — regardless of the requested
    port/host.  ``host`` defaults to all interfaces (a scrape endpoint
    exists to be scraped); pass ``127.0.0.1`` (``--obs-host``) to keep it
    loopback-only on shared hosts.  The process ``RemoteMirror`` singleton
    is merged by default (it is empty unless something feeds it)."""
    global _exporter
    with _lock:
        if _exporter is None:
            _exporter = MetricsExporter(
                registry if registry is not None else get_registry(),
                port,
                host,
                mirror if mirror is not None else get_remote_mirror(),
            )
        return _exporter


def stop_exporter() -> None:
    """Tear the singleton down (tests), and turn span timing off, which the
    CLIs turn on with it."""
    global _exporter
    with _lock:
        if _exporter is not None:
            _exporter.stop()
            _exporter = None
    enable_spans(False)


def current_exporter() -> Optional[MetricsExporter]:
    with _lock:
        return _exporter
