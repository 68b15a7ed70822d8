"""Policy serving: batched recurrent inference as a service.

Port of ``r2d2dpg_tpu/serving/``:

- ``sessions``: per-client LSTM carries in preallocated device slabs;
- ``batcher``: dynamic micro-batching with a flush deadline and
  bounded-queue admission control;
- ``reload``: checkpoint hot-reload polled between batches;
- ``health``: queue/latency/staleness snapshot for operators;
- ``service``: the orchestrating ``PolicyService`` (one worker thread
  owns all device work; every step at ``max_batch`` rows);
- ``router``: N ``PolicyService`` workers behind a session-affine
  rendezvous-hash router with broadcast hot-reload.

Entry point: ``python -m r2d2dpg_torch.serve --config ... --checkpoint-dir
...`` (JSONL over stdio; see ``serve.py`` and docs/SERVING.md).
"""

from r2d2dpg_torch.serving.batcher import MicroBatcher, Request
from r2d2dpg_torch.serving.health import HealthSnapshot
from r2d2dpg_torch.serving.reload import CheckpointHotReloader, actor_params_template
from r2d2dpg_torch.serving.router import (
    FanoutReloader,
    ServiceRouter,
    build_router,
    default_worker_devices,
    worker_for,
)
from r2d2dpg_torch.serving.service import (
    BAD_REQUEST,
    INTERNAL_ERROR,
    ActResult,
    PolicyService,
)
from r2d2dpg_torch.serving.sessions import (
    SessionSlabs,
    SessionStore,
    gather_carries,
    scatter_carries,
)

__all__ = [
    "ActResult",
    "BAD_REQUEST",
    "CheckpointHotReloader",
    "FanoutReloader",
    "HealthSnapshot",
    "INTERNAL_ERROR",
    "MicroBatcher",
    "PolicyService",
    "Request",
    "ServiceRouter",
    "SessionSlabs",
    "SessionStore",
    "actor_params_template",
    "build_router",
    "default_worker_devices",
    "gather_carries",
    "scatter_carries",
    "worker_for",
]
