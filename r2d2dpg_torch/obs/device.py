"""Device plane: memory gauges, MFU and the profiler window of a learner loop.

A torch rewrite of ``r2d2dpg_tpu/obs/device.py``, driven by every learner
loop (``Trainer.run``, the pipelined executor, the fleet drain, the sampler
pull loop):

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
  {device=}`` (on the CPU no allocator reports, and the gauges stay
  absent), and sets ``r2d2dpg_device_mfu``;
- ``run_stats()`` gives the window's deltas: the peak allocated bytes
  since ``begin_run`` (which resets the peak), the train phases noted,
  and the compile columns of the JAX monitor.

**MFU.**  ``flops_of(fn, *args)`` runs ``fn`` once under
``torch.utils.flop_counter.FlopCounterMode`` (the counterpart of XLA's
``cost_analysis()``; it counts the matrix products, convolutions and
attention the call dispatches, on whichever thread autograd runs the
backward).  The JAX loops lower their learn program lazily; the port
counts while the loop executes: each loop runs its FIRST train or drain
phase under the counter (``count_flops``: a real phase, its results
bitwise those of an uncounted one) and hands the total to
``set_learn_cost`` before that phase's ``note_learn``, so every phase of
the run is counted (the JAX loops add 0 for the phases dispatched before
the next ``publish`` evaluates their lazy cost).  The fleet drain counts
each distinct width once and passes it to ``note_learn(flops)``.
``r2d2dpg_device_mfu`` is the FLOP rate over the window between two
``publish()`` calls divided by ``--device-peak-flops``; a peak of 0 leaves
the gauge at 0 rather than inventing a denominator.

**Profiler window.**  ``arm_profile("P:N", logdir)`` captures train or
drain phases P..P+N-1 of whichever loop runs with ``torch.profiler``
(device activity on the card, and host activity), exported as a Chrome
trace under ``logdir`` when the window closes; ``profile_start`` /
``profile_stop`` (or ``profile_failed``) flight events bracket it, so
``obs.flight merge --trace-out`` stamps it as a ``profile_window`` span.
``end_run()`` closes a window still open.  One profiler session per
process: nothing else may profile while a window is open.

The port runs eagerly, so nothing compiles after warm-up and the compile
sentinel has nothing to watch: ``compile_count``, ``compile_seconds`` and
``steady_recompiles`` read 0, and ``r2d2dpg_device_steady_recompiles_total``
is not published.  The sentinel arrives with ``torch.compile`` or CUDA
graphs, whose captures are the port's compiles.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from r2d2dpg_torch.obs.flight import flight_event
from r2d2dpg_torch.obs.registry import Registry, get_registry

METRIC_NAMES = (
    "r2d2dpg_device_hbm_bytes_in_use",
    "r2d2dpg_device_hbm_bytes_peak",
    "r2d2dpg_device_hbm_bytes_limit",
    "r2d2dpg_device_learn_flops_total",
    "r2d2dpg_device_mfu",
    "r2d2dpg_device_peak_flops",
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


def count_flops(fn: Callable, *args, **kwargs) -> Tuple[object, Optional[float]]:
    """``(fn(*args, **kwargs), FLOPs)``: the call runs once, for real,
    under ``FlopCounterMode``; the count is None when it is 0."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        out = fn(*args, **kwargs)
    total = float(counter.get_total_flops())
    return out, (total if total > 0.0 else None)


def flops_of(fn: Callable, *args, **kwargs) -> Optional[float]:
    """The FLOPs of one call of ``fn`` (None when it counts none)."""
    return count_flops(fn, *args, **kwargs)[1]


def parse_profile_window(spec: str) -> Tuple[int, int]:
    """``"P:N"`` -> (first phase, phase count), both >= 1.  The capture
    spans train/drain phases P..P+N-1 on the run's resolved loop."""
    parts = str(spec).split(":")
    if len(parts) != 2:
        raise ValueError(
            f"--profile-window expects 'P:N' (phase:steps), got {spec!r}"
        )
    try:
        phase, steps = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(
            f"--profile-window expects integers 'P:N', got {spec!r}"
        )
    if phase < 1 or steps < 1:
        raise ValueError(
            f"--profile-window phase and steps must be >= 1, got {spec!r}"
        )
    return phase, steps


class DeviceMonitor:
    """One learner loop's run window, the device memory and MFU gauges,
    and the profiler window.

    The process singleton (``get_device_monitor``) is what the loops
    drive; a test makes its own over a private ``Registry``."""

    def __init__(self, registry: Optional[Registry] = None):
        reg = registry if registry is not None else get_registry()
        self._lock = threading.Lock()
        self._installed = False
        self._steady = False
        self._phase = 0
        self._learn_phases = 0
        # MFU accounting.
        self._learn_flops_per_dispatch = 0.0
        self._learn_cost_fn: Optional[Callable[[], Optional[float]]] = None
        self._flops_total = 0.0
        self._peak_flops = 0.0
        self._pub_anchor: Optional[Tuple[float, float]] = None
        # Profiler window: (first phase, phases, logdir), and while a
        # capture runs (its first phase, t_wall at start, the profiler).
        self._profile: Optional[Tuple[int, int, str]] = None
        self._profile_active: Optional[Tuple[int, float, object]] = None
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
        self._obs_flops = reg.counter(
            "r2d2dpg_device_learn_flops_total",
            "FlopCounterMode FLOPs of dispatched learn/drain phases",
        )
        self._obs_mfu = reg.gauge(
            "r2d2dpg_device_mfu",
            "learn-phase FLOP rate over --device-peak-flops across the "
            "last log-cadence window (0 while the peak is unknown)",
        )
        self._obs_peak_flops = reg.gauge(
            "r2d2dpg_device_peak_flops",
            "the --device-peak-flops denominator this run was told "
            "(0 = unknown: MFU stays 0 rather than inventing a peak)",
        )

    # ------------------------------------------------------------ lifecycle
    def install(self) -> "DeviceMonitor":
        """Idempotent; eager torch has no compile events to listen to."""
        with self._lock:
            self._installed = True
        return self

    def begin_run(self) -> None:
        """Open a run window: counters zeroed, steady cleared, the MFU
        window reopened, the allocator's peak reset on every card this
        process has touched."""
        with self._lock:
            self._steady = False
            self._phase = 0
            self._learn_phases = 0
            self._pub_anchor = None
        for d in _cuda_devices():
            torch.cuda.reset_peak_memory_stats(d)

    def mark_steady(self) -> None:
        """The loop's work is warm (its first train or drain phase ran)."""
        with self._lock:
            self._steady = True

    def end_run(self) -> None:
        """Close the run window (the loop's ``finally``) and stop a
        profiler capture still open."""
        with self._lock:
            self._steady = False
        self._stop_profile(reason="end_run")

    @property
    def steady(self) -> bool:
        with self._lock:
            return self._steady

    def on_phase(self, phase: int) -> None:
        """The 1-based index of the train or drain phase about to run:
        starts an armed capture at phase P, stops it before phase P+N."""
        with self._lock:
            self._phase = int(phase)
        prof = self._profile
        if prof is None:
            return
        p0, n, logdir = prof
        if self._profile_active is None:
            if phase == p0:
                self._start_profile(phase, logdir)
        elif phase >= p0 + n:
            self._stop_profile(phase=phase)

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

    # ------------------------------------------------------------------ MFU
    def configure(self, peak_flops: float = 0.0) -> None:
        self._peak_flops = max(float(peak_flops), 0.0)
        self._obs_peak_flops.set(self._peak_flops)

    def set_learn_cost(self, cost) -> None:
        """The learn phase's FLOPs per dispatch: a number, or a zero-arg
        callable evaluated lazily at the next ``publish()``."""
        if callable(cost):
            self._learn_cost_fn = cost
        else:
            self._learn_flops_per_dispatch = max(float(cost or 0.0), 0.0)
            self._learn_cost_fn = None

    def note_learn(self, flops: Optional[float] = None) -> None:
        """One train or drain phase dispatched (host-side adds, no fetch).
        ``flops`` overrides the registered per-dispatch cost (the fleet
        drain passes its per-width count)."""
        f = float(flops) if flops else self._learn_flops_per_dispatch
        with self._lock:
            self._learn_phases += 1
            if f > 0.0:
                self._flops_total += f
        if f > 0.0:
            self._obs_flops.inc(f)

    def _maybe_eval_learn_cost(self) -> None:
        fn = self._learn_cost_fn
        if fn is None:
            return
        self._learn_cost_fn = None
        try:
            with self.expected("cost_analysis"), self.program("cost_analysis"):
                f = fn()
        except Exception:  # noqa: BLE001 — MFU is best-effort telemetry
            f = None
        if f:
            self._learn_flops_per_dispatch = float(f)

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
        """Refresh the memory gauges (allocator reads, no device sync) and
        the MFU window."""
        self._maybe_eval_learn_cost()
        for d in _cuda_devices():
            dev = str(d)
            self._obs_in_use.labels(device=dev).set(
                float(torch.cuda.memory_allocated(d)))
            self._obs_peak.labels(device=dev).set(
                float(torch.cuda.max_memory_allocated(d)))
            self._obs_limit.labels(device=dev).set(
                float(torch.cuda.get_device_properties(d).total_memory))
        now = time.monotonic()
        with self._lock:
            anchor = self._pub_anchor
            total = self._flops_total
            self._pub_anchor = (now, total)
            peak = self._peak_flops
        if anchor is None or now <= anchor[0]:
            return
        rate = (total - anchor[1]) / (now - anchor[0])
        self._obs_mfu.set(rate / peak if peak > 0.0 else 0.0)

    # ------------------------------------------------------------- profiler
    def arm_profile(self, spec: str, logdir: str) -> Tuple[int, int]:
        """Arm ``--profile-window P:N`` into ``logdir`` (created at
        capture start).  Returns the parsed (phase, steps)."""
        phase, steps = parse_profile_window(spec)
        self._profile = (phase, steps, str(logdir))
        return phase, steps

    def _start_profile(self, phase: int, logdir: str) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if _cuda_devices():
            activities.append(ProfilerActivity.CUDA)
        try:
            os.makedirs(logdir, exist_ok=True)
            prof = profile(activities=activities)
            prof.start()
        except Exception as e:  # noqa: BLE001 — telemetry, not the run
            flight_event("profile_failed", error=f"{type(e).__name__}: {e}")
            self._profile = None
            return
        self._profile_active = (phase, time.time(), prof)
        flight_event("profile_start", phase=phase, logdir=logdir)

    def _stop_profile(self, phase: Optional[int] = None, reason=None) -> None:
        active = self._profile_active
        if active is None:
            return
        prof_spec = self._profile
        self._profile_active = None
        self._profile = None  # one window per run
        start_phase, t0, prof = active
        try:
            for d in _cuda_devices():
                # The window's last kernels finish before the capture ends.
                torch.cuda.synchronize(d)
            prof.stop()
            seconds = round(time.time() - t0, 3)
            end = (phase - 1) if phase is not None else self._phase
            prof.export_chrome_trace(os.path.join(
                prof_spec[2], f"profile_p{start_phase}-{end}_pid{os.getpid()}"
                ".pt.trace.json"))
        except Exception as e:  # noqa: BLE001
            flight_event("profile_failed", error=f"{type(e).__name__}: {e}")
            return
        flight_event(
            "profile_stop",
            phase=phase,
            start_phase=start_phase,
            seconds=seconds,
            **({"reason": reason} if reason else {}),
        )


_MONITOR = DeviceMonitor()


def get_device_monitor() -> DeviceMonitor:
    """The process device monitor (module singleton)."""
    return _MONITOR
