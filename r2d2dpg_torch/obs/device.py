"""Device plane, run-window subset: memory gauges and a learner loop's window.

A torch rewrite of the part of ``r2d2dpg_tpu/obs/device.py`` that the
learner loops drive (``Trainer.run``, the pipelined executor):

- ``install`` / ``begin_run`` / ``mark_steady`` / ``on_phase`` /
  ``note_learn`` / ``end_run``: a loop opens a run window, marks the phase
  after which its work is warm, reports each train or drain phase it
  starts and finishes, and closes the window in its ``finally``;
- ``program(label)`` / ``label_thread(label)`` / ``expected(reason)``:
  per-thread labels for what the thread is dispatching, and declared
  windows (the log fetch, fault injection) where new work is legitimate;
- ``publish()`` (on the log cadence, from ``Trainer._obs_publish``) reads
  ``torch.cuda.memory_allocated`` / ``max_memory_allocated`` and the
  card's memory size into ``r2d2dpg_device_hbm_bytes_{in_use,peak,limit}
  {device=}``; on the CPU no allocator reports, and the gauges stay absent;
- ``run_stats()`` gives the window's deltas: the peak allocated bytes
  since ``begin_run`` (which resets the peak), the train phases noted,
  and the compile columns of the JAX monitor.

The port runs eagerly, so nothing compiles after warm-up and the compile
sentinel has nothing to watch: ``compile_count``, ``compile_seconds`` and
``steady_recompiles`` read 0.  The sentinel arrives with ``torch.compile``
or CUDA graphs, whose captures are the port's compiles.  Left for the rest
of telemetry: the MFU numerator (``flops_of`` / ``set_learn_cost``) and
the profiler capture window (``arm_profile``).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import torch

from r2d2dpg_torch.obs.registry import Registry, get_registry

METRIC_NAMES = (
    "r2d2dpg_device_hbm_bytes_in_use",
    "r2d2dpg_device_hbm_bytes_peak",
    "r2d2dpg_device_hbm_bytes_limit",
)

_tls = threading.local()


class _Label:
    """Set a thread-local attribute for the length of a ``with`` block."""

    def __init__(self, attr: str, value):
        self._attr, self._value = attr, value

    def __enter__(self):
        self._prev = getattr(_tls, self._attr, None)
        setattr(_tls, self._attr, self._value)
        return self

    def __exit__(self, *exc):
        setattr(_tls, self._attr, self._prev)
        return False


class _Expected:
    """A declared window on this thread (nests)."""

    def __enter__(self):
        _tls.expected = getattr(_tls, "expected", 0) + 1
        return self

    def __exit__(self, *exc):
        _tls.expected = max(getattr(_tls, "expected", 1) - 1, 0)
        return False


def _cuda_devices():
    """Indices of the cards this process has touched (none on the CPU)."""
    if not torch.cuda.is_initialized():
        return []
    return list(range(torch.cuda.device_count()))


class DeviceMonitor:
    """One learner loop's run window and the device memory gauges.

    The process singleton (``get_device_monitor``) is what the loops
    drive; a test makes its own over a private ``Registry``."""

    def __init__(self, registry: Optional[Registry] = None):
        reg = registry if registry is not None else get_registry()
        self._lock = threading.Lock()
        self._installed = False
        self._steady = False
        self._phase = 0
        self._learn_phases = 0
        self._obs_in_use = reg.gauge(
            "r2d2dpg_device_hbm_bytes_in_use",
            "per-device allocator bytes in use (torch.cuda.memory_allocated)",
            labelnames=("device",),
        )
        self._obs_peak = reg.gauge(
            "r2d2dpg_device_hbm_bytes_peak",
            "per-device peak allocated bytes since the run window opened",
            labelnames=("device",),
        )
        self._obs_limit = reg.gauge(
            "r2d2dpg_device_hbm_bytes_limit",
            "per-device memory size (absent on the CPU)",
            labelnames=("device",),
        )

    # ------------------------------------------------------------ lifecycle
    def install(self) -> "DeviceMonitor":
        """Idempotent; eager torch has no compile events to listen to."""
        with self._lock:
            self._installed = True
        return self

    def begin_run(self) -> None:
        """Open a run window: counters zeroed, steady cleared, the
        allocator's peak reset on every card this process has touched."""
        with self._lock:
            self._steady = False
            self._phase = 0
            self._learn_phases = 0
        for d in _cuda_devices():
            torch.cuda.reset_peak_memory_stats(d)

    def mark_steady(self) -> None:
        """The loop's work is warm (its first train or drain phase ran)."""
        with self._lock:
            self._steady = True

    def end_run(self) -> None:
        """Close the run window (the loop's ``finally``)."""
        with self._lock:
            self._steady = False

    @property
    def steady(self) -> bool:
        with self._lock:
            return self._steady

    def on_phase(self, phase: int) -> None:
        """The 1-based index of the train or drain phase about to run."""
        with self._lock:
            self._phase = int(phase)

    def note_learn(self) -> None:
        """One train or drain phase dispatched."""
        with self._lock:
            self._learn_phases += 1

    # ----------------------------------------------------- labels / windows
    def program(self, label: str) -> _Label:
        """Label what this thread dispatches while the block is open."""
        return _Label("program", str(label))

    def label_thread(self, label: str) -> None:
        """Sticky per-thread default label (the pipeline's collector)."""
        _tls.program = str(label)

    def expected(self, reason: str) -> _Expected:
        """Declare a window on this thread where new work is legitimate."""
        del reason
        return _Expected()

    @staticmethod
    def current_program() -> Optional[str]:
        """This thread's label (``program`` block, else ``label_thread``)."""
        return getattr(_tls, "program", None)

    # --------------------------------------------------------------- gauges
    def run_stats(self) -> Dict[str, float]:
        """The window's columns (the executors' ``stats()`` carry them)."""
        self.publish()
        peak = max(
            (float(torch.cuda.max_memory_allocated(d)) for d in _cuda_devices()),
            default=0.0,
        )
        with self._lock:
            learn = float(self._learn_phases)
        return {
            "compile_count": 0.0,
            "compile_seconds": 0.0,
            "steady_recompiles": 0.0,
            "peak_hbm_bytes": peak,
            "learn_phases": learn,
        }

    def publish(self) -> None:
        """Refresh the memory gauges: allocator reads, no device sync."""
        for d in _cuda_devices():
            dev = str(d)
            self._obs_in_use.labels(device=dev).set(
                float(torch.cuda.memory_allocated(d)))
            self._obs_peak.labels(device=dev).set(
                float(torch.cuda.max_memory_allocated(d)))
            self._obs_limit.labels(device=dev).set(
                float(torch.cuda.get_device_properties(d).total_memory))


_MONITOR = DeviceMonitor()


def get_device_monitor() -> DeviceMonitor:
    """The process device monitor (module singleton)."""
    return _MONITOR
