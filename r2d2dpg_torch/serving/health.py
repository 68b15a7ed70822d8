"""Serving health snapshot: what an operator (or load balancer) reads.

Port of ``r2d2dpg_tpu/serving/health.py``.  One flat dataclass of
floats and ints, so it drops into ``MetricLogger.log`` (CSV) and into the
serve CLI's JSONL ``health`` reply.  Latency percentiles come from sliding
``PercentileWindow``s: recent behavior, not lifetime averages.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from r2d2dpg_torch.obs import get_registry


@dataclasses.dataclass(frozen=True)
class HealthSnapshot:
    """Point-in-time serving health.

    - ``queue_depth``: requests waiting (bounded by the batcher's max_queue).
    - ``batch_occupancy``: mean real rows / computed rows over recent
      batches: how much of each padded policy step was useful work.
    - ``latency_p50_ms`` / ``latency_p99_ms``: request latency
      (enqueue -> response) over the recent window.
    - ``step_p50_ms`` / ``step_p99_ms``: device policy-step latency alone.
    - ``params_step``: learner step of the params being served (-1 before
      any load), ``params_staleness_s``: seconds since they were loaded.
    - ``requests_ok`` / ``requests_shed``: lifetime admission counters —
      the shed rate is the load-shedding signal.
    - ``sessions_active`` / ``sessions_evicted``: session-table pressure.
    - ``worker_errors``: batches the serving worker failed and recovered
      from (each one dropped all session carries); nonzero means look at
      ``last_worker_error``.
    """

    queue_depth: int
    batch_occupancy: float
    latency_p50_ms: float
    latency_p99_ms: float
    step_p50_ms: float
    step_p99_ms: float
    params_step: int
    params_staleness_s: float
    requests_ok: int
    requests_shed: int
    sessions_active: int
    sessions_evicted: int
    worker_errors: int = 0
    last_reload_error: Optional[str] = None
    last_worker_error: Optional[str] = None

    def as_scalars(self) -> Dict[str, float]:
        """Numeric view for ``MetricLogger.log`` (drops the error strings:
        CSV rows are floats; the errors show in the JSONL health reply)."""
        out = dataclasses.asdict(self)
        out.pop("last_reload_error")
        out.pop("last_worker_error")
        return {k: float(v) for k, v in out.items()}

    def publish(self, registry=None) -> None:
        """Refit the scalar view onto the obs registry as
        ``r2d2dpg_serving_<field>`` gauges, the same numbers the CSV health
        rows and the JSONL health reply show.  Registration is idempotent:
        each publish is a set() per field."""
        reg = registry if registry is not None else get_registry()
        for k, v in self.as_scalars().items():
            reg.gauge(
                f"r2d2dpg_serving_{k}", "PolicyService health field"
            ).set(v)
