"""Telemetry: the instrument registry, the flight recorder and its span
ring, experience-path traces, the divergence watchdog, the experience-quality
plane and the device plane's run window.

Port of the part of ``r2d2dpg_tpu/obs/`` the port's loops publish into:
``registry``, ``flight`` (event and span rings, ``trace.json``), ``trace``,
``watchdog``, ``quality`` and the run-window subset of ``device``.  The
exporter, the health engine, the flight ``merge`` CLI, the federation and
the device plane's MFU and profiler window come with the rest of telemetry
(ROADMAP queue 1 item 8).
"""

from r2d2dpg_torch.obs.device import DeviceMonitor, get_device_monitor
from r2d2dpg_torch.obs.flight import (
    FlightRecorder,
    chrome_trace,
    flight_event,
    get_flight_recorder,
)
from r2d2dpg_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    get_registry,
)
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
    "Histogram",
    "Registry",
    "WatchdogConfig",
    "chrome_trace",
    "flight_event",
    "get_device_monitor",
    "get_flight_recorder",
    "get_registry",
]
