"""Telemetry: one process-wide namespace for every subsystem's signals.

Port of ``r2d2dpg_tpu/obs/``, with the JAX package's module names:

- ``registry``: typed Counter/Gauge/Histogram instruments with label sets
  (``get_registry()`` is the process singleton), their Prometheus text
  rendering, and the ``RemoteMirror`` federation of other processes'
  snapshots (``merge_remote``);
- ``exporter``: the stdlib-HTTP scrape point on ``--obs-port``
  (``/metrics``, ``/metrics.json``, ``/health``, ``/healthz``);
- ``health``: the ``/health`` rule engine, ``{verdict, findings[]}`` over
  the registry and the mirror, each verdict transition a flight event;
- ``flight``: bounded event and span rings dumped to ``flight.jsonl`` and
  ``trace.json``, and the ``merge`` CLI that fuses a run directory's dumps;
- ``watchdog``: NaN/Inf and norm checks on the log cadence;
- ``trace``: sampled experience-path hop spans;
- ``device``: the device plane (memory gauges, the MFU numerator by
  ``FlopCounterMode``, the ``--profile-window`` capture by
  ``torch.profiler``);
- ``quality``: the experience-quality plane;
- ``enable_spans(on)``: the switch of the program's spans
  (``utils/profiling.py::annotate``; off by default).  The train and
  serve CLIs turn it on with ``--obs-port`` (``stop_exporter`` turns it
  off again).  Each span then lands in the flight recorder's span ring
  (``obs.flight merge --trace-out`` fuses the dumps; ``parent`` and the
  unit's ``trace_id`` in each event's args) and in the histogram
  ``r2d2dpg_span_seconds{span=<name>}``; the serving batcher adds each
  request's queue wait to ``r2d2dpg_serve_queue_wait_seconds``.  The
  spans: ``trainer/{collect,emit_add,learn}``,
  ``learner/{is_weights,burn_in,targets,critic_forward,critic_backward,``
  ``actor_forward,actor_backward,optimize,priorities,quality,``
  ``graph_replay}`` (a step replayed as a CUDA graph shows
  ``graph_replay`` in place of the eager step's parts, and counts into
  ``r2d2dpg_learner_graph_total{event,reason}``, ``agents/graph.py``),
  ``replay/{sample,add,write_back}`` and
  ``serve/{next_batch,admit,policy_step,answer}``.

The multi-process ``allgather_into_mirror`` comes with the multi-device
slice.
"""

from r2d2dpg_torch.obs import device  # noqa: F401 - obs.device.* is the API
from r2d2dpg_torch.obs.device import DeviceMonitor, get_device_monitor
from r2d2dpg_torch.obs.exporter import (
    MetricsExporter,
    current_exporter,
    start_exporter,
    stop_exporter,
)
from r2d2dpg_torch.obs.flight import (
    FlightRecorder,
    chrome_trace,
    flight_event,
    get_flight_recorder,
    set_flight_identity,
)
from r2d2dpg_torch.obs.health import HealthConfig, HealthEngine
from r2d2dpg_torch.obs import quality  # noqa: F401 - obs.quality.* is the API
from r2d2dpg_torch.obs.quality import (
    QualityPlane,
    get_quality_plane,
    reset_quality_plane,
)
from r2d2dpg_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    RemoteMirror,
    allgather_into_mirror,
    get_registry,
    get_remote_mirror,
    merge_remote,
    render_prometheus,
)
from r2d2dpg_torch.obs import trace  # noqa: F401 - obs.trace.* is the span API
from r2d2dpg_torch.utils.profiling import enable_spans
from r2d2dpg_torch.obs.watchdog import (
    DivergenceError,
    DivergenceWatchdog,
    WatchdogConfig,
)

__all__ = [
    "Counter",
    "DeviceMonitor",
    "DivergenceError",
    "DivergenceWatchdog",
    "FlightRecorder",
    "Gauge",
    "HealthConfig",
    "HealthEngine",
    "Histogram",
    "MetricsExporter",
    "QualityPlane",
    "Registry",
    "RemoteMirror",
    "WatchdogConfig",
    "allgather_into_mirror",
    "chrome_trace",
    "current_exporter",
    "device",
    "enable_spans",
    "flight_event",
    "get_device_monitor",
    "get_flight_recorder",
    "get_quality_plane",
    "get_registry",
    "get_remote_mirror",
    "merge_remote",
    "quality",
    "reset_quality_plane",
    "render_prometheus",
    "set_flight_identity",
    "start_exporter",
    "stop_exporter",
    "trace",
]
