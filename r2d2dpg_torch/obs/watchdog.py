"""Divergence watchdog: a loud, early abort on numeric poisoning.

Port of ``r2d2dpg_tpu/obs/watchdog.py`` (copied; it imports no JAX).  One
NaN in a learner update poisons params, priorities and every later
checkpoint.  The watchdog reads the host-side scalars the log cadence has
already fetched (the trainer's and the pipelined executor's one batched
fetch), so it adds no device sync, and checks

- NaN / Inf anywhere in the learner's metrics (losses, means, norms);
- ``grad_norm``  > ``grad_norm_max``  (default 1e6);
- ``param_norm`` > ``param_norm_max`` (default 1e7).

A trip records a ``watchdog_trip`` flight event and raises
``DivergenceError``; the train CLI dumps ``flight.jsonl``, names the last
checkpoint on disk, skips the final save and exits with code 2.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from r2d2dpg_torch.obs.flight import FlightRecorder, get_flight_recorder
from r2d2dpg_torch.obs.registry import Registry, get_registry

# Metric keys the threshold checks look for (absent keys are skipped; the
# NaN/Inf sweep covers every key regardless).
GRAD_NORM_KEY = "grad_norm"
PARAM_NORM_KEY = "param_norm"


class DivergenceError(RuntimeError):
    """A learner-output check tripped; carries the offending scalars."""

    def __init__(self, reason: str, step: int, scalars: Dict[str, float]):
        super().__init__(reason)
        self.reason = reason
        self.step = step
        self.scalars = dict(scalars)


@dataclasses.dataclass(frozen=True)
class WatchdogConfig:
    grad_norm_max: float = 1e6
    param_norm_max: float = 1e7


class DivergenceWatchdog:
    """Stateless check + trip bookkeeping (counter, flight event)."""

    def __init__(
        self,
        config: WatchdogConfig = WatchdogConfig(),
        *,
        registry: Optional[Registry] = None,
        recorder: Optional[FlightRecorder] = None,
    ):
        self.config = config
        self._recorder = recorder if recorder is not None else get_flight_recorder()
        reg = registry if registry is not None else get_registry()
        self._trips = reg.counter(
            "r2d2dpg_watchdog_trips_total",
            "divergence-watchdog trips (the process aborts on the first)",
        )
        self._checks = reg.counter(
            "r2d2dpg_watchdog_checks_total", "log-cadence watchdog sweeps"
        )

    # ----------------------------------------------------------------- check
    def check(self, step: int, scalars: Dict[str, float]) -> None:
        """Sweep one log cadence's host-side scalars; raise on divergence."""
        self._checks.inc()
        reason = self._find_violation(scalars)
        if reason is None:
            return
        self._trips.inc()
        self._recorder.record(
            "watchdog_trip",
            step=int(step),
            reason=reason,
            scalars={k: _jsonable(v) for k, v in scalars.items()},
        )
        raise DivergenceError(reason, int(step), scalars)

    def _find_violation(self, scalars: Dict[str, float]) -> Optional[str]:
        cfg = self.config
        for k, v in scalars.items():
            f = float(v)
            if math.isnan(f) or math.isinf(f):
                return f"non-finite learner output: {k} = {f}"
        g = scalars.get(GRAD_NORM_KEY)
        if g is not None and float(g) > cfg.grad_norm_max:
            return (
                f"{GRAD_NORM_KEY} {float(g):.4g} exceeds "
                f"grad_norm_max {cfg.grad_norm_max:.4g}"
            )
        p = scalars.get(PARAM_NORM_KEY)
        if p is not None and float(p) > cfg.param_norm_max:
            return (
                f"{PARAM_NORM_KEY} {float(p):.4g} exceeds "
                f"param_norm_max {cfg.param_norm_max:.4g}"
            )
        return None


def _jsonable(v) -> float:
    f = float(v)
    # JSON has no NaN/Inf literals; stringify so the flight dump stays valid.
    return f if math.isfinite(f) else str(f)  # type: ignore[return-value]
