"""Session-affine router: N PolicyService workers behind one front door.

Port of ``r2d2dpg_tpu/serving/router.py``.  N independent
``PolicyService`` workers, each with its own device, session slab,
micro-batcher and worker thread, sit behind a router that pins every
session to exactly one worker:

                        act(session, obs)
                              │
                      ServiceRouter (this file)
              rendezvous-hash(session_id) -> worker w
          ┌───────────────────┼───────────────────┐
          ▼                   ▼                   ▼
     PolicyService[0]    PolicyService[1]  ...  PolicyService[N-1]

Affinity is a CORRECTNESS contract: a session's LSTM carry lives in one
worker's slab.  The router uses a stateless rendezvous hash
(highest-random-weight over ``crc32(session_id | worker)`` and murmur3's
finalizer), golden-equal to the JAX package's, and keeps a bounded
session -> worker pin map only to DETECT violations
(``r2d2dpg_serve_affinity_violations_total``, which must stay 0).

Admission stays per worker: each worker's bounded queue sheds with the
``utils/codes.py`` codes at its own door, under its own ``worker=`` label.

Hot-reload is polled ONCE and broadcast: one ``CheckpointHotReloader``
restores from disk (``FanoutReloader`` serializes it), and every worker
moves the params onto its own device between its own batches.

Devices: worker ``w`` runs on ``cuda:(w % device_count)``, or every worker
on the CPU.  On one card the workers share it; behaviour across several
cards is not verified.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from r2d2dpg_torch.obs import flight_event, get_registry
from r2d2dpg_torch.serving.batcher import Request
from r2d2dpg_torch.serving.service import ActResult, PolicyService


def _mix32(h: int) -> int:
    """murmur3's 32-bit finalizer: a stable bijection with full avalanche.

    crc32 alone is XOR-linear — crc(s+"|0") ^ crc(s+"|1") is a CONSTANT,
    so two workers' rendezvous scores differ by a fixed XOR and every
    session id sharing a prefix (user-0, user-1, ...) piles onto one
    worker.  The multiply/shift finalizer decorrelates the scores while
    staying process- and platform-stable (no dependency, no salt).
    """
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


def worker_for(session_id: str, num_workers: int) -> int:
    """Rendezvous (highest-random-weight) hash of a session onto a worker.

    crc32+finalizer is stable across processes, platforms, and Python
    restarts — unlike ``hash()``, which is salted per process — so the
    same session id lands on the same worker after any restart with the
    same worker count.  O(N) per lookup is fine: N is the device count,
    not the session count.
    """
    if num_workers < 1:
        raise ValueError("num_workers must be >= 1")
    sid = str(session_id).encode("utf-8", "surrogatepass")
    best, best_score = 0, -1
    for w in range(num_workers):
        score = _mix32(zlib.crc32(sid + b"|" + str(w).encode()))
        if score > best_score:
            best, best_score = w, score
    return best


def default_worker_devices(num_workers: int, device: Any = None) -> List[torch.device]:
    """One device per worker: ``cuda:(w % device_count)``, or every worker
    on ``device`` when it names a non-CUDA device (``"cpu"``)."""
    if device is not None and torch.device(device).type != "cuda":
        return [torch.device(device)] * num_workers
    count = torch.cuda.device_count()
    if count < 1:
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: --device cpu) "
            "to run on the CPU"
        )
    return [torch.device("cuda", w % count) for w in range(num_workers)]


class FanoutReloader:
    """One disk poller, N subscribers: broadcast checkpoint hot-reload.

    Wraps a single ``CheckpointHotReloader``.  Each worker holds a
    ``view()`` with the reloader interface ``PolicyService`` expects
    (``load_latest`` / ``poll`` / ``current_step`` / ``staleness_s`` /
    ``last_error``); whichever worker's between-batches poll fires first
    pays the (rate-limited) directory check and restore, and every other
    view picks the cached params up on ITS next poll, moved onto its own
    device, without touching disk.  The base reloader's ``reloads``
    counter therefore counts restores, not workers.
    """

    def __init__(self, base):
        self.base = base
        self._lock = threading.RLock()
        self._version = 0
        self._params: Any = None
        self._step: Optional[int] = None

    def load_initial(self) -> Tuple[Any, Optional[int], int]:
        with self._lock:
            if self._version == 0:
                self._params = self.base.load_latest()
                self._step = self.base.current_step
                self._version = 1
            return self._params, self._step, self._version

    def poll_shared(self, applied_version: int):
        """Advance the shared copy if due; return (params, step, version)
        when ``applied_version`` is behind, else None."""
        with self._lock:
            fresh = self.base.poll()
            if fresh is not None:
                self._params = fresh
                self._step = self.base.current_step
                self._version += 1
            if self._version == applied_version:
                return None
            return self._params, self._step, self._version

    def view(self, device: Any = None) -> "_ReloaderView":
        return _ReloaderView(self, device)


class _ReloaderView:
    """One worker's handle on the fanout (applies swaps at its own pace)."""

    def __init__(self, fanout: FanoutReloader, device: Any = None):
        self._fanout = fanout
        self._device = device
        self._applied = 0
        self.current_step: Optional[int] = None

    def _place(self, params):
        if self._device is not None:
            return {k: v.to(self._device) for k, v in params.items()}
        return params

    def load_latest(self):
        params, step, version = self._fanout.load_initial()
        self._applied = version
        self.current_step = step
        return self._place(params)

    def poll(self):
        got = self._fanout.poll_shared(self._applied)
        if got is None:
            return None
        params, step, version = got
        self._applied = version
        self.current_step = step
        return self._place(params)

    @property
    def last_error(self) -> Optional[str]:
        return self._fanout.base.last_error

    def staleness_s(self) -> float:
        return self._fanout.base.staleness_s()


class ServiceRouter:
    """The front door over N workers: route, detect, aggregate.

    Mirrors the ``PolicyService`` client surface (``act`` / ``act_async`` /
    ``end_session`` / ``health`` / context manager) so the serve CLI and
    harnesses drive either interchangeably.
    """

    def __init__(
        self,
        services: Sequence[PolicyService],
        *,
        registry: Any = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if not services:
            raise ValueError("router needs at least one worker service")
        self.services = tuple(services)
        self.num_workers = len(self.services)
        self._clock = clock
        self._lock = threading.Lock()
        # Violation-detector memory, NOT the routing source (routing is the
        # stateless hash).  Bounded: forgetting an old pin only shrinks the
        # detection window, it cannot misroute anything.
        self._session_worker: Dict[str, int] = {}
        self._map_cap = max(
            4096, 4 * sum(s.sessions.max_sessions for s in self.services)
        )
        self._affinity_violations = 0
        reg = registry if registry is not None else get_registry()
        reg.gauge(
            "r2d2dpg_serve_workers", "worker services behind the router"
        ).set(float(self.num_workers))
        reg.gauge(
            "r2d2dpg_serve_routed_sessions",
            "sessions currently pinned in the router's affinity detector",
        ).set_fn(lambda: float(len(self._session_worker)))
        self._obs_affinity = reg.counter(
            "r2d2dpg_serve_affinity_violations_total",
            "sessions the hash sent to a different worker than their pin "
            "(must stay 0 — each violation is a lost LSTM carry)",
        )

    # ------------------------------------------------------------- lifecycle
    def start(self, *, warmup: bool = True) -> "ServiceRouter":
        for svc in self.services:
            svc.start(warmup=warmup)
        return self

    def stop(self) -> None:
        for svc in self.services:
            svc.stop()

    def __enter__(self) -> "ServiceRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ----------------------------------------------------------------- route
    def worker_for(self, session_id: str) -> int:
        return worker_for(session_id, self.num_workers)

    def _pin(self, sid: str, w: int) -> None:
        with self._lock:
            prev = self._session_worker.get(sid)
            if prev is None:
                self._session_worker[sid] = w
                over = len(self._session_worker) - self._map_cap
                if over > 0:
                    for old in list(self._session_worker)[:over]:
                        del self._session_worker[old]
            elif prev != w:
                self._affinity_violations += 1
                self._obs_affinity.inc()
                flight_event(
                    "affinity_violation",
                    session=sid,
                    pinned=int(prev),
                    routed=int(w),
                )
                self._session_worker[sid] = w

    def act_async(
        self, session_id: str, obs, *, reset: bool = False
    ) -> Request:
        sid = str(session_id)
        w = self.worker_for(sid)
        self._pin(sid, w)
        return self.services[w].act_async(sid, obs, reset=reset)

    def act(
        self,
        session_id: str,
        obs,
        *,
        reset: bool = False,
        timeout: Optional[float] = 30.0,
    ) -> ActResult:
        req = self.act_async(session_id, obs, reset=reset)
        if not req.wait(timeout):
            return ActResult(
                "timeout", None, -1, self._clock() - req.enqueued_at
            )
        return ActResult(req.code, req.action, req.params_step, req.latency_s)

    def end_session(self, session_id: str) -> bool:
        sid = str(session_id)
        w = self.worker_for(sid)
        with self._lock:
            self._session_worker.pop(sid, None)
        return self.services[w].end_session(sid)

    # ---------------------------------------------------------------- health
    @property
    def affinity_violations(self) -> int:
        with self._lock:
            return self._affinity_violations

    def health(self) -> Dict[str, Any]:
        """Aggregate + per-worker snapshots (JSON-ready dict — the router's
        health is a composite, not one worker's dataclass)."""
        per_worker = {}
        totals = {
            "requests_ok": 0,
            "requests_shed": 0,
            "sessions_active": 0,
            "worker_errors": 0,
        }
        for i, svc in enumerate(self.services):
            snap = dataclasses.asdict(svc.health())
            per_worker[svc.worker_label or str(i)] = snap
            for k in totals:
                totals[k] += snap[k]
        return {
            "workers": self.num_workers,
            "affinity_violations": self.affinity_violations,
            **totals,
            "per_worker": per_worker,
        }


def build_router(
    actor,
    *,
    num_workers: int,
    params: Any = None,
    reloader: Any = None,
    obs_shape: Optional[Tuple[int, ...]] = None,
    devices: Optional[Sequence[Any]] = None,
    device: Any = None,
    registry: Any = None,
    params_step: int = -1,
    clock: Callable[[], float] = time.monotonic,
    **service_kw,
) -> ServiceRouter:
    """Stand up N per-device workers behind a router.

    ``reloader`` (a plain ``CheckpointHotReloader``) is wrapped in a
    ``FanoutReloader`` so its restores broadcast; ``params`` (frozen
    deployments, tests) is moved onto each worker's device by
    ``PolicyService``.  ``device`` picks the devices when ``devices`` is
    not given (``default_worker_devices``).  Extra kwargs flow to every
    worker unchanged (max_sessions, max_batch, max_queue, flush_ms,
    session_ttl_s...): capacity knobs are PER WORKER.
    """
    if num_workers < 1:
        raise ValueError("num_workers must be >= 1")
    devs = (
        list(devices)
        if devices is not None
        else default_worker_devices(num_workers, device)
    )
    if len(devs) < num_workers:
        devs = [devs[w % len(devs)] for w in range(num_workers)]
    fanout = FanoutReloader(reloader) if reloader is not None else None
    services = []
    for w in range(num_workers):
        services.append(
            PolicyService(
                actor,
                params=params,
                obs_shape=obs_shape,
                reloader=fanout.view(devs[w]) if fanout is not None else None,
                params_step=params_step,
                device=devs[w],
                worker_label=str(w),
                registry=registry,
                clock=clock,
                **service_kw,
            )
        )
    return ServiceRouter(services, registry=registry, clock=clock)
