"""Dynamic micro-batcher: coalesce concurrent act() calls into one step.

Port of ``r2d2dpg_tpu/serving/batcher.py`` (pure host code).  The batcher
coalesces whatever requests are in flight into ONE policy step of at most
``max_batch`` requests.  The JAX batcher also picks the bucket (the
executable) a batch runs in; here every step runs at ``max_batch`` rows
(``service.py``), so there is no bucket to pick.

Latency discipline: the first request of a batch starts a flush deadline
(``flush_ms``); the batch launches when ``max_batch`` requests wait OR the
deadline lapses, whichever is first.  An idle service adds at most one
deadline of latency to a lone request.

Admission control: the queue is bounded (``max_queue``).  ``submit`` on a
full queue fails IMMEDIATELY; the caller turns that into a ``SHED_QUEUE``
response code, not an exception, so overload degrades to fast explicit
rejections instead of unbounded queueing (the client can back off).

Ordering: at most one request per session rides in a batch (two steps of
one session in one batch would gather the same carry and race the
write-back).  Extras are held over (FIFO per session) for the next batch.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Deque, List, Optional

import numpy as np

from r2d2dpg_torch.utils.codes import OK


@dataclasses.dataclass
class Request:
    """One pending act() call; doubles as its own future (event + slots)."""

    session_id: str
    obs: np.ndarray
    reset: bool
    enqueued_at: float
    _done: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False
    )
    code: str = OK
    action: Optional[np.ndarray] = None
    params_step: int = -1
    latency_s: float = 0.0

    def finish(
        self,
        code: str,
        action: Optional[np.ndarray] = None,
        params_step: int = -1,
        *,
        clock=time.monotonic,
    ) -> None:
        self.code = code
        self.action = action
        self.params_step = params_step
        self.latency_s = clock() - self.enqueued_at
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    @property
    def done(self) -> bool:
        return self._done.is_set()


class MicroBatcher:
    """Bounded request queue + coalescing (host-side only).

    One consumer (the service worker thread) calls ``next_batch``; any
    number of producers call ``submit``.  The holdover deque keeps
    same-session extras strictly FIFO across batches.
    """

    def __init__(
        self,
        max_batch: int = 32,
        *,
        max_queue: int = 256,
        flush_ms: float = 5.0,
        clock=time.monotonic,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = int(max_batch)
        self.flush_s = flush_ms / 1000.0
        self.max_queue = max_queue
        self._clock = clock
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._queue: Deque[Request] = collections.deque()
        self._holdover: Deque[Request] = collections.deque()
        self._closed = False
        self.submitted = 0
        self.shed_queue_full = 0

    # -------------------------------------------------------------- producer
    def submit(self, req: Request) -> bool:
        """Enqueue; False (caller sheds) when the bounded queue is full."""
        with self._lock:
            if self._closed:
                return False
            # Holdover rides the same bound: it is queued work too.
            if len(self._queue) + len(self._holdover) >= self.max_queue:
                self.shed_queue_full += 1
                return False
            self._queue.append(req)
            self.submitted += 1
            self._nonempty.notify()
            return True

    # -------------------------------------------------------------- consumer
    def next_batch(self, poll_s: float = 0.05) -> List[Request]:
        """Block (up to ``poll_s``) for work, then coalesce one batch.

        Returns [] on timeout or close so the worker can run its
        between-batches duties (hot-reload poll, TTL sweep, health log) at
        least every ``poll_s`` even under zero traffic.
        """
        with self._nonempty:
            if not self._queue and not self._holdover:
                self._nonempty.wait(poll_s)
            if self._closed or (not self._queue and not self._holdover):
                return []
        # Flush window: give stragglers until the deadline to join, unless
        # a full batch already waits.
        deadline = self._clock() + self.flush_s
        while True:
            with self._lock:
                ready = len(self._holdover) + len(self._queue)
            if ready >= self.max_batch:
                break
            remaining = deadline - self._clock()
            if remaining <= 0:
                break
            time.sleep(min(remaining, 0.001))
        batch: List[Request] = []
        seen: set = set()
        kept: Deque[Request] = collections.deque()
        with self._lock:
            # Holdover first (strict per-session FIFO), then fresh queue.
            for source in (self._holdover, self._queue):
                while source and len(batch) < self.max_batch:
                    req = source.popleft()
                    if req.session_id in seen:
                        kept.append(req)
                        continue
                    seen.add(req.session_id)
                    batch.append(req)
            self._holdover = kept + self._holdover  # leftovers stay FIFO
        return batch

    def drain(self) -> List[Request]:
        """Close and return everything still queued (for SHUTDOWN replies)."""
        with self._lock:
            self._closed = True
            out = list(self._holdover) + list(self._queue)
            self._holdover.clear()
            self._queue.clear()
            self._nonempty.notify_all()
            return out

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._queue) + len(self._holdover)

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed
