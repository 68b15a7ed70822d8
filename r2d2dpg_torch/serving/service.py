"""PolicyService: the request-driven front door of a trained R2D2-DPG actor.

Port of ``r2d2dpg_tpu/serving/service.py``.  One worker thread owns ALL
device work, so nothing guards params or slabs; request threads only
enqueue and wait:

    act(session_id, obs) ──> MicroBatcher (bounded queue, flush deadline)
                                  │ one batch at a time
                                  ▼
          policy step: gather carries ─ actor ─ write carries back
              ▲ params                                  │ actions
              │                                         ▼
    CheckpointHotReloader.poll()  (between batches)   Request.finish()

A hot reload swaps one params dict between batches: no session state is
touched and every request is computed against one param version.

**A session's actions do not depend on what shares its batches.**  The
JAX service compiles one executable per bucket; eager torch would run each
batch at its own row count instead, and a GEMM's result for a row can
change with the row count, and even with the row's position at a fixed
count (the CPU's small-matrix GEMM computes rows 1, 3, 5, 7 of an 8-row
product with a 3-wide output apart from rows 0, 2, 4, 6).  So a policy
step here
  1. always runs at one row count, ``max_batch`` (the largest of the JAX
     CLI's buckets): padding rows carry zero observations, ``reset=1`` and
     the scratch slot; and
  2. computes every row as a one-row problem of its own
     (``rowwise_policy_step_fn``: the params are viewed with a leading
     axis of that row count, the nets' ensemble axis, so each matmul is a
     batched product whose entries all run the same code).
A row's action then depends on its own inputs only, bitwise, whichever
requests share its batch and wherever it sits (docs/SERVING.md's
contract).  ``max_batch`` also bounds how many requests a batch admits.

Each batch makes one host-to-device copy (slots, resets and observations
packed into one float32 array) and one device-to-host copy (the actions).

Degradation under load: bigger batches -> queue up to ``max_queue`` ->
shed with ``SHED_QUEUE``; a full session table sheds with
``SHED_SESSIONS`` after a TTL sweep.  Both are response CODES, not
exceptions.  A failed batch is answered with ``INTERNAL_ERROR``, the slabs
are rebuilt, every session is dropped and the error shows in health; if
the rebuild fails too (a CUDA error that poisons the context), the worker
stops and every later request gets ``SHUTDOWN``.
"""

from __future__ import annotations

import copy
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from r2d2dpg_torch.device import resolve_device
from r2d2dpg_torch.models.actor_critic import ActorNet, policy_step_fn
from r2d2dpg_torch.obs import flight_event, get_registry
from r2d2dpg_torch.serving.batcher import MicroBatcher, Request
from r2d2dpg_torch.serving.health import HealthSnapshot
from r2d2dpg_torch.serving.sessions import (
    SessionStore,
    gather_carries,
    scatter_carries,
)
from r2d2dpg_torch.utils.codes import OK, SHED_QUEUE, SHED_SESSIONS, SHUTDOWN
from r2d2dpg_torch.utils.metrics import MetricLogger, PercentileWindow

BAD_REQUEST = "bad_request"
INTERNAL_ERROR = "internal_error"

# Slots ride to the device as float32 in the packed batch: exact below 2**24.
MAX_SESSIONS = 2**24 - 1


def expand_rows(params: Dict[str, torch.Tensor], rows: int) -> Dict[str, torch.Tensor]:
    """Every parameter viewed (no copy) with a leading axis of ``rows``."""
    return {k: v.expand(rows, *v.shape) for k, v in params.items()}


def rowwise_policy_step_fn(actor: ActorNet):
    """``step(row_params, obs, carry, reset) -> (action, carry)`` over rows
    that are computed independently of one another.

    ``row_params`` is ``expand_rows(params, R)`` for ``R`` rows; ``obs`` is
    ``[R, ...]``, the carry leaves ``[R, H]`` and ``reset`` ``[R]``.  Each
    row runs as ensemble member ``i`` with a batch of one, so every matmul
    is a batched product of one-row entries computed by the same code.
    """
    step = policy_step_fn(actor)

    def run(row_params, obs, carry, reset):
        action, carry = step(
            row_params, obs.unsqueeze(1), tuple(c.unsqueeze(1) for c in carry),
            reset.unsqueeze(1),
        )
        return action.squeeze(1), tuple(c.squeeze(1) for c in carry)

    return run


class _WorkerInstruments:
    """Per-worker ``r2d2dpg_serve_*`` registry wiring (router scale-out).

    Registered only when the service runs as a ROUTED worker
    (``worker_label`` set); a lone service publishes the unlabelled
    ``r2d2dpg_serving_*`` gauges through ``HealthSnapshot.publish()``.
    Gauges are pull-time ``set_fn`` closures over service attributes;
    counters and latency histograms are observed on the worker thread.
    """

    def __init__(self, service: "PolicyService", label: str, registry=None):
        reg = registry if registry is not None else get_registry()
        self.label = str(label)
        self._sheds = reg.counter(
            "r2d2dpg_serve_sheds_total",
            "requests shed by this worker, by shed code",
            labelnames=("worker", "code"),
        )
        self.requests = reg.counter(
            "r2d2dpg_serve_requests_total",
            "requests served OK by this worker",
            labelnames=("worker",),
        ).labels(worker=self.label)
        self.worker_errors = reg.counter(
            "r2d2dpg_serve_worker_errors_total",
            "serve-loop failures this worker survived",
            labelnames=("worker",),
        ).labels(worker=self.label)
        self.latency = reg.histogram(
            "r2d2dpg_serve_latency_seconds",
            "enqueue->finish latency of OK requests (p50/p99 on scrape)",
            labelnames=("worker",),
        ).labels(worker=self.label)
        self.step = reg.histogram(
            "r2d2dpg_serve_step_seconds",
            "device policy-step wall time per batch",
            labelnames=("worker",),
        ).labels(worker=self.label)
        reg.gauge(
            "r2d2dpg_serve_queue_depth",
            "requests waiting in this worker's micro-batch queue",
            labelnames=("worker",),
        ).labels(worker=self.label).set_fn(lambda: float(service.batcher.depth))
        reg.gauge(
            "r2d2dpg_serve_queue_limit",
            "this worker's admission bound (max_queue)",
            labelnames=("worker",),
        ).labels(worker=self.label).set(float(service.batcher.max_queue))
        reg.gauge(
            "r2d2dpg_serve_slab_occupancy",
            "live sessions / slab capacity on this worker",
            labelnames=("worker",),
        ).labels(worker=self.label).set_fn(
            lambda: service.sessions.active / max(service.sessions.max_sessions, 1)
        )
        reg.gauge(
            "r2d2dpg_serve_params_staleness_seconds",
            "age of this worker's served params (0 when frozen)",
            labelnames=("worker",),
        ).labels(worker=self.label).set_fn(
            lambda: (
                service.reloader.staleness_s() if service.reloader is not None else 0.0
            )
        )
        self.params_step = reg.gauge(
            "r2d2dpg_serve_params_step",
            "learner step of this worker's served params",
            labelnames=("worker",),
        ).labels(worker=self.label)

    def shed(self, code: str) -> None:
        self._sheds.labels(worker=self.label, code=code).inc()


@dataclasses.dataclass(frozen=True)
class ActResult:
    """What a client gets back from ``act``: a code, and on OK the action
    plus the learner step of the params that computed it."""

    code: str
    action: Optional[np.ndarray]
    params_step: int
    latency_s: float


class PolicyService:
    """Batched recurrent policy inference with sessions and hot-reload.

    Either pass ``params`` (tests, frozen deployments) or a ``reloader``
    (live deployments: the initial params come from
    ``reloader.load_latest()`` and refresh on its poll cadence).  Runs on
    ``cuda`` unless ``device`` names another device.
    """

    def __init__(
        self,
        actor: ActorNet,
        params: Optional[Dict[str, torch.Tensor]] = None,
        *,
        obs_shape: Optional[Tuple[int, ...]] = None,
        max_sessions: int = 64,
        max_batch: int = 32,
        max_queue: int = 256,
        flush_ms: float = 5.0,
        session_ttl_s: float = 300.0,
        reloader: Any = None,
        params_step: int = -1,
        logger: Optional[MetricLogger] = None,
        log_every_s: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
        device: Any = None,
        worker_label: Optional[str] = None,
        registry: Any = None,
    ):
        if params is None and reloader is None:
            raise ValueError("need initial params or a reloader")
        if max_sessions > MAX_SESSIONS:
            raise ValueError(f"max_sessions must be <= {MAX_SESSIONS}")
        # A module of its own: ``functional_call`` swaps the module's
        # parameters during a call, so two threads must never share one
        # (routed workers are built from one actor).
        self.actor = copy.deepcopy(actor)
        self.device = resolve_device(device)
        self.obs_shape = tuple(obs_shape) if obs_shape is not None else None
        self._clock = clock
        self.sessions = SessionStore(
            max_sessions, self.actor.initial_carry, ttl_s=session_ttl_s, clock=clock
        )
        self.batcher = MicroBatcher(
            max_batch, max_queue=max_queue, flush_ms=flush_ms, clock=clock
        )
        # Every policy step runs at this row count (module docstring).
        self.step_rows = self.batcher.max_batch
        self.reloader = reloader
        self._set_params(params if params is not None else reloader.load_latest())
        self._params_step = (
            reloader.current_step if params is None else params_step
        )
        self._slabs = self.sessions.init_slabs(self.device)
        self._policy = rowwise_policy_step_fn(self.actor)

        self._logger = logger
        self._log_every_s = log_every_s
        self._last_log_t = clock()
        # Registry publish cadence: 1 Hz, apart from the CSV log cadence.
        self._obs_every_s = 1.0
        self._last_obs_t = clock()
        self._latency_win = PercentileWindow()
        self._step_win = PercentileWindow()
        self._occupancy_ema = 0.0
        self._requests_ok = 0
        self._batches = 0
        self._worker_errors = 0
        self._shed_sessions = 0
        self._last_worker_error: Optional[str] = None
        # Worker-only: set by the first served batch when no obs_shape was
        # configured (see the screening in _run_batch).
        self._inferred_obs_shape: Optional[Tuple[int, ...]] = None
        self.worker_label = str(worker_label) if worker_label is not None else None
        # A routed worker's flight events carry its label.
        self._flight_kv = {"worker": self.worker_label} if self.worker_label else {}
        self._obs_serve = (
            _WorkerInstruments(self, self.worker_label, registry)
            if self.worker_label is not None
            else None
        )
        if self._obs_serve is not None:
            self._obs_serve.params_step.set(
                float(self._params_step) if self._params_step is not None else -1.0
            )
        self._stats_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _set_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Serve ``params`` (moved onto this service's device) from now on."""
        self._row_params = expand_rows(
            {k: v.to(self.device) for k, v in params.items()}, self.step_rows
        )

    # ------------------------------------------------------------- lifecycle
    def start(self, *, warmup: bool = True) -> "PolicyService":
        if self._thread is not None:
            raise RuntimeError("service already started")
        if self._stop.is_set():
            # The batcher closed during shutdown and every carry is
            # orphaned: a restarted instance would shed all traffic.
            raise RuntimeError(
                "service was stopped and cannot restart; build a new PolicyService"
            )
        if warmup:
            self.warmup()
        self._thread = threading.Thread(
            target=self._serve_loop, name="policy-serve", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "PolicyService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def warmup(self) -> None:
        """One step on the scratch slot, so the first real request pays no
        allocator or library start-up cost."""
        if self.obs_shape is None:
            return  # nothing to make observations from
        zero = np.zeros(self.obs_shape, np.float32)
        self.policy_step([self.sessions.scratch_slot], [1.0], [zero])

    def policy_step(
        self, slots: List[int], resets: List[float], obs: List[np.ndarray]
    ) -> np.ndarray:
        """One policy step of ``len(slots)`` requests at ``step_rows`` rows.

        Reads and writes the sessions' carries in the slabs; returns the
        real rows' actions ``[len(slots), A]`` on the host.  Called by the
        worker thread only (and by ``warmup`` before it starts).
        """
        n, rows = len(slots), self.step_rows
        shape = obs[0].shape
        packed = np.zeros((rows, 2 + int(np.prod(shape))), np.float32)
        packed[:, 0] = self.sessions.scratch_slot
        packed[:, 1] = 1.0
        packed[:n, 0] = slots
        packed[:n, 1] = resets
        packed[:n, 2:] = np.stack(obs).reshape(n, -1)
        x = torch.from_numpy(packed).to(self.device)
        slot_t = x[:, 0].long()
        carry = gather_carries(self._slabs, slot_t)
        action, new_carry = self._policy(
            self._row_params, x[:, 2:].reshape((rows,) + shape), carry, x[:, 1]
        )
        scatter_carries(self._slabs, slot_t, new_carry)
        return action[:n].cpu().numpy()

    # ------------------------------------------------------------------- act
    def act_async(self, session_id: str, obs: np.ndarray, *, reset: bool = False) -> Request:
        """Enqueue one step; returns the request-future (``.wait()`` then
        read ``.code`` / ``.action``).  Sheds synchronously on a full queue."""
        obs = np.asarray(obs, np.float32)
        req = Request(
            session_id=str(session_id), obs=obs, reset=reset, enqueued_at=self._clock()
        )
        if self.obs_shape is not None and obs.shape != self.obs_shape:
            req.finish(BAD_REQUEST, clock=self._clock)
            return req
        if self._thread is None or self._stop.is_set():
            req.finish(SHUTDOWN, clock=self._clock)
            return req
        if not self.batcher.submit(req):
            # The admission bound or a shutdown race: tell the client which
            # (a shed invites backoff-and-retry, a shutdown does not).
            code = SHUTDOWN if self.batcher.closed else SHED_QUEUE
            if code == SHED_QUEUE:
                flight_event("shed", code=code, session=req.session_id, **self._flight_kv)
                if self._obs_serve is not None:
                    self._obs_serve.shed(code)
            req.finish(code, clock=self._clock)
        return req

    def act(
        self,
        session_id: str,
        obs: np.ndarray,
        *,
        reset: bool = False,
        timeout: Optional[float] = 30.0,
    ) -> ActResult:
        """Blocking act(): one policy step for this session's stream."""
        req = self.act_async(session_id, obs, reset=reset)
        if not req.wait(timeout):
            # The request stays in flight (the worker still finishes it);
            # the client just stops waiting.
            return ActResult("timeout", None, -1, self._clock() - req.enqueued_at)
        return ActResult(req.code, req.action, req.params_step, req.latency_s)

    def end_session(self, session_id: str) -> bool:
        """Client goodbye: free the slot without waiting for TTL."""
        return self.sessions.release(str(session_id))

    # ------------------------------------------------------------ the worker
    def _serve_loop(self) -> None:
        while not self._stop.is_set():
            # Housekeeping (reload poll, TTL sweep, health log) never touches
            # the slabs, so its failure is noted and skipped without
            # dropping session state; only a failed batch forces the rebuild.
            try:
                self._between_batches()
            except Exception as e:  # noqa: BLE001 - the worker must outlive it
                self._note_worker_error(e)
            batch = None
            try:
                batch = self.batcher.next_batch()
                if batch:
                    self._run_batch(batch)
            except Exception as e:  # noqa: BLE001 - the worker must outlive it
                self._recover_from_worker_error(e, batch)
        for req in self.batcher.drain():
            req.finish(SHUTDOWN, clock=self._clock)

    def _note_worker_error(self, exc: Exception) -> None:
        with self._stats_lock:
            self._worker_errors += 1
            self._last_worker_error = f"{type(exc).__name__}: {exc}"
        flight_event("worker_error", error=self._last_worker_error, **self._flight_kv)
        if self._obs_serve is not None:
            self._obs_serve.worker_errors.inc()

    def _recover_from_worker_error(self, exc: Exception, batch) -> None:
        """Fail the affected requests, rebuild the slabs, keep serving.

        A step that raised may have written some carries and not others, so
        the slabs are rebuilt and every session is dropped (each client's
        next request re-allocates with a reset carry).  The error shows in
        the health snapshot.  If the rebuild fails as well, the worker stops.
        """
        self._note_worker_error(exc)
        try:
            self._slabs = self.sessions.init_slabs(self.device)
            self.sessions.clear()
        except Exception as e:  # noqa: BLE001 - report, then stop the worker
            with self._stats_lock:
                self._last_worker_error = f"unrecoverable: {type(e).__name__}: {e}"
            self._stop.set()
        finally:
            # Answered after the rebuild: a client's retry finds clean state.
            for req in batch or []:
                if not req.done:
                    req.finish(INTERNAL_ERROR, clock=self._clock)

    def _between_batches(self) -> None:
        """Duties that never interleave with a policy step: param swap, TTL
        sweep, health publishing and logging."""
        if self.reloader is not None:
            fresh = self.reloader.poll()
            if fresh is not None:
                self._set_params(fresh)
                self._params_step = self.reloader.current_step
                flight_event(
                    "hot_reload", params_step=int(self._params_step), **self._flight_kv
                )
                if self._obs_serve is not None:
                    self._obs_serve.params_step.set(float(self._params_step))
        evicted = self.sessions.evict_expired()
        if evicted:
            flight_event("ttl_eviction", count=int(evicted), **self._flight_kv)
        if self._clock() - self._last_obs_t >= self._obs_every_s:
            self._last_obs_t = self._clock()
            # Routed workers publish the labelled serve_* family instead; N
            # of them would overwrite one another's unlabelled gauges.
            if self._obs_serve is None:
                self.health().publish()
        if (
            self._logger is not None
            and self._clock() - self._last_log_t >= self._log_every_s
        ):
            self._last_log_t = self._clock()
            self._logger.log(self._batches, self.health().as_scalars())

    def _run_batch(self, batch) -> None:
        # Screen shapes BEFORE stacking: without a configured obs_shape one
        # ragged observation must fail as that client's bad request, not
        # cost every session its carry.  The first request ever served
        # sets the expectation, and it sticks.
        expect = self.obs_shape or self._inferred_obs_shape
        screened = []
        for req in batch:
            if expect is None:
                expect = req.obs.shape
            if req.obs.shape != expect:
                req.finish(BAD_REQUEST, clock=self._clock)
                continue
            screened.append(req)
        self._inferred_obs_shape = expect
        admitted, slots, resets = [], [], []
        for req in screened:
            got = self.sessions.acquire(req.session_id)
            if got is None:
                with self._stats_lock:
                    self._shed_sessions += 1
                flight_event(
                    "shed", code=SHED_SESSIONS, session=req.session_id, **self._flight_kv
                )
                if self._obs_serve is not None:
                    self._obs_serve.shed(SHED_SESSIONS)
                req.finish(SHED_SESSIONS, clock=self._clock)
                continue
            slot, is_new = got
            admitted.append(req)
            slots.append(slot)
            # A new slot may hold a dead session's carry: reset=1 zeroes it
            # inside the step, as at an episode boundary in training.
            resets.append(1.0 if (is_new or req.reset) else 0.0)
        if not admitted:
            return
        n = len(admitted)
        t0 = self._clock()
        action = self.policy_step(slots, resets, [r.obs for r in admitted])
        step_s = self._clock() - t0
        for i, req in enumerate(admitted):
            req.finish(OK, action[i], self._params_step, clock=self._clock)
        with self._stats_lock:
            self._requests_ok += n
            self._batches += 1
            occupancy = n / self.step_rows
            self._occupancy_ema = (
                0.9 * self._occupancy_ema + 0.1 * occupancy
                if self._batches > 1
                else occupancy
            )
        self._step_win.add(step_s)
        for req in admitted:
            self._latency_win.add(req.latency_s)
        if self._obs_serve is not None:
            self._obs_serve.requests.inc(n)
            self._obs_serve.step.observe(step_s)
            for req in admitted:
                self._obs_serve.latency.observe(req.latency_s)

    # ---------------------------------------------------------------- health
    def health(self) -> HealthSnapshot:
        lat50, lat99 = self._latency_win.percentiles((50.0, 99.0))
        st50, st99 = self._step_win.percentiles((50.0, 99.0))
        with self._stats_lock:
            ok, occ = self._requests_ok, self._occupancy_ema
            errs, last_err = self._worker_errors, self._last_worker_error
            shed_sessions = self._shed_sessions
        staleness = self.reloader.staleness_s() if self.reloader is not None else 0.0
        return HealthSnapshot(
            queue_depth=self.batcher.depth,
            batch_occupancy=occ,
            latency_p50_ms=lat50 * 1e3,
            latency_p99_ms=lat99 * 1e3,
            step_p50_ms=st50 * 1e3,
            step_p99_ms=st99 * 1e3,
            params_step=int(self._params_step) if self._params_step is not None else -1,
            params_staleness_s=staleness,
            requests_ok=ok,
            # BOTH load-shedding modes count.
            requests_shed=self.batcher.shed_queue_full + shed_sessions,
            sessions_active=self.sessions.active,
            sessions_evicted=self.sessions.evictions,
            worker_errors=errs,
            last_reload_error=(
                self.reloader.last_error if self.reloader is not None else None
            ),
            last_worker_error=last_err,
        )
