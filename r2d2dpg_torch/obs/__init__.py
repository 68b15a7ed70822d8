"""Telemetry: the instrument registry and the flight recorder.

Port of the part of ``r2d2dpg_tpu/obs/`` the serving stack and the
checkpoint manager publish into (``registry``, the event ring of
``flight``).  The exporter, the health engine, the watchdog, traces and
the device plane come with the telemetry slice (ROADMAP queue 1 item 8).
"""

from r2d2dpg_torch.obs.flight import (
    FlightRecorder,
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

__all__ = [
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "Registry",
    "flight_event",
    "get_flight_recorder",
    "get_registry",
]
