"""Experience-path tracing: where a staged batch spends its time.

Port of ``r2d2dpg_tpu/obs/trace.py`` (pure Python there too; copied so
the port imports nothing of the JAX package).  The hops of the full fleet
path are named here, each with a latency histogram
(``r2d2dpg_trace_<hop>_seconds``) and a sampled span in the flight
recorder's span ring (``obs/flight.py``):

::

    collect -> encode -> transit -> decode -> enqueue -> coalesce
                                                -> arena_add -> learn

The in-process pipelined executor (``training/pipeline.py``) records the
hops that exist without a wire, as contiguous intervals:

- ``collect``    the collector's phase: env steps, window shift, emit,
                 up to the collector stream finishing the batch;
- ``enqueue``    staging-queue residency, to the learner's ``get``;
- ``arena_add``  dequeue to the drain's dispatch end (on a card the
                 kernels are queued, not done);
- ``learn``      dispatch end to the learner stream finishing the drain.

The wire, sampler and shard hops stay in ``HOPS`` for the fleet and shard
slices.  ``maybe_start(rate)`` decides per batch at collection time; rate
0 (the default) returns None without touching any RNG or clock, so an
untraced run does nothing here.  A sampled batch costs two stream
synchronizations (collector and learner), so keep rates at or below ~0.1
in runs measured for throughput.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Optional

from r2d2dpg_torch.obs.flight import get_flight_recorder
from r2d2dpg_torch.obs.registry import get_registry

# The central-drain wire path's 8 contiguous hops (the fleet's actors).
WIRE_HOPS = (
    "collect",
    "encode",
    "transit",
    "decode",
    "enqueue",
    "coalesce",
    "arena_add",
    "learn",
)
# The in-network sampler's pull path (``sample_req -> batch_return ->
# learn``), recorded all-or-nothing per sampled train phase and never
# mixed with the wire chain.
SAMPLER_HOPS = (
    "sample_req",
    "batch_return",
)
# A standalone shard process's own chain inside the learner's
# ``sample_req`` window: request receive (wire + decode), the prioritized
# draw, and the batch encode + send.
SHARD_HOPS = (
    "req_receive",
    "shard_draw",
    "batch_encode",
)
HOPS = WIRE_HOPS + SAMPLER_HOPS + SHARD_HOPS


@dataclasses.dataclass
class TraceStamp:
    """One sampled batch's identity + the actor-side hop timestamps.

    The three timestamps are what crosses the wire (the fixed-size trace
    sidecar of ``fleet/wire.py``); learner-side hops use the learner's own
    clock reads.  Mutable on purpose: the owning stage stamps its end time
    in place (``t_encode_end`` is stamped by the packer itself — encode
    cannot time itself from outside the payload it produces)."""

    trace_id: int
    t_collect_start: float
    t_collect_end: float = 0.0
    t_encode_end: float = 0.0


def maybe_start(sample_rate: float) -> Optional[TraceStamp]:
    """Per-batch sampling decision at collection time.

    Rate 0 (the default) returns None without touching any RNG or clock —
    the unsampled hot path does literally nothing."""
    if sample_rate <= 0.0:
        return None
    if sample_rate < 1.0 and random.random() >= sample_rate:
        return None
    return TraceStamp(
        trace_id=random.getrandbits(47), t_collect_start=time.time()
    )


def hop_histogram(hop: str):
    """The per-hop latency summary (registered idempotently on first use)."""
    if hop not in HOPS:
        raise ValueError(f"unknown trace hop {hop!r}; hops are {HOPS}")
    return get_registry().histogram(
        f"r2d2dpg_trace_{hop}_seconds",
        f"experience-path '{hop}' hop latency (sampled batches only)",
    )


def record_hop(
    hop: str, t_start: float, t_end: float, trace_id: int, **attrs
) -> float:
    """One hop of one sampled batch: histogram observation + span ring.

    Durations clamp at 0 (cross-process wall clocks can skew by more than
    a fast hop's width); the span keeps the raw start time so the dumped
    timeline still shows true ordering.  Returns the clamped duration."""
    dur = max(float(t_end) - float(t_start), 0.0)
    hop_histogram(hop).observe(dur)
    get_flight_recorder().record_span(hop, trace_id, float(t_start), dur, **attrs)
    return dur
