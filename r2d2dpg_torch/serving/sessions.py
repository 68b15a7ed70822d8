"""Per-session recurrent-state store: preallocated device slabs.

Port of ``r2d2dpg_tpu/serving/sessions.py``.  A recurrent policy's action
depends on the LSTM carry accumulated over the whole session, so the
service keeps one ``(c, h)`` pair per session.  As in the replay arena,
each carry leaf is ONE preallocated ``[max_sessions + 1, H]`` device
tensor; a batch reads its rows with ``index_select`` and writes them back
in place with ``index_copy_``.

Row ``max_sessions`` (``scratch_slot``) is a write-only scratch row: every
padding row of a policy step points at it, so the write-back needs no
validity mask.  Duplicate indices occur only there, and which padding
row's write wins is unspecified and harmless: the row is never read as
real state.

Slot bookkeeping (which client owns which row, TTL) is host-side: a dict
and a free list under a lock.  Freed rows are not zeroed on the device: a
new session's first step carries ``reset=1`` and the actor zeroes the
carry inside the step (``zeros_where_reset``), the same mechanic as an
episode boundary in training.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

Carry = Any


@dataclasses.dataclass
class SessionSlabs:
    """Carry storage: one ``[S + 1, ...]`` tensor per carry leaf (``S =
    max_sessions``; the extra row is the scratch row).  An empty tuple for
    feedforward actors: gather and scatter then do nothing."""

    carries: Tuple[torch.Tensor, ...]


def gather_carries(slabs: SessionSlabs, slots: torch.Tensor) -> Carry:
    """The carries of one batch of slot indices (``[B]`` int64, on the slabs' device)."""
    return tuple(buf.index_select(0, slots) for buf in slabs.carries)


def scatter_carries(slabs: SessionSlabs, slots: torch.Tensor, carries: Carry) -> None:
    """Write updated carries back at ``slots``, in place."""
    for buf, new in zip(slabs.carries, carries):
        buf.index_copy_(0, slots, new)


@dataclasses.dataclass
class _SlotInfo:
    slot: int
    last_used: float


class SessionStore:
    """Host-side session table over a fixed pool of slab rows.

    TTL eviction is lazy: expired sessions are swept on an allocation
    attempt that finds no free row (and on demand by ``evict_expired``), so
    an idle service holds stale rows but a full one reclaims them before
    shedding.
    """

    def __init__(
        self,
        max_sessions: int,
        initial_carry_fn: Callable[[int, Any], Carry],
        *,
        ttl_s: float = 300.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if max_sessions < 1:
            raise ValueError("max_sessions must be >= 1")
        self.max_sessions = max_sessions
        self.ttl_s = ttl_s
        self._initial_carry_fn = initial_carry_fn
        self._clock = clock
        self._lock = threading.Lock()
        self._by_id: Dict[str, _SlotInfo] = {}
        self._free: List[int] = list(range(max_sessions - 1, -1, -1))
        self._evictions = 0

    # ----------------------------------------------------------------- slabs
    @property
    def scratch_slot(self) -> int:
        return self.max_sessions

    def init_slabs(self, device) -> SessionSlabs:
        """Preallocate the carry slabs on ``device`` (zeros; rows are never
        re-zeroed afterwards, see the module docstring)."""
        example = self._initial_carry_fn(1, "meta")
        return SessionSlabs(carries=tuple(
            torch.zeros((self.max_sessions + 1,) + tuple(leaf.shape[1:]),
                        dtype=leaf.dtype, device=device)
            for leaf in example
        ))

    # ----------------------------------------------------------------- slots
    def acquire(self, session_id: str) -> Optional[Tuple[int, bool]]:
        """Slot for ``session_id``, allocating on first sight.

        Returns ``(slot, is_new)``, or ``None`` when the table is full even
        after TTL eviction (the caller sheds the request).  Touches the
        session's TTL clock.
        """
        now = self._clock()
        with self._lock:
            info = self._by_id.get(session_id)
            if info is not None:
                info.last_used = now
                return info.slot, False
            if not self._free:
                self._evict_expired_locked(now)
            if not self._free:
                return None
            slot = self._free.pop()
            self._by_id[session_id] = _SlotInfo(slot=slot, last_used=now)
            return slot, True

    def release(self, session_id: str) -> bool:
        """Explicitly end a session (client said goodbye); True if it existed."""
        with self._lock:
            info = self._by_id.pop(session_id, None)
            if info is None:
                return False
            self._free.append(info.slot)
            return True

    def evict_expired(self) -> int:
        """Sweep sessions idle for longer than ``ttl_s``; returns count."""
        with self._lock:
            return self._evict_expired_locked(self._clock())

    def clear(self) -> int:
        """Drop EVERY session (the service rebuilt its slabs after a failed
        batch, so every carry is gone; each client's next request
        re-allocates with ``is_new`` and so a reset).  Returns count."""
        with self._lock:
            n = len(self._by_id)
            for info in self._by_id.values():
                self._free.append(info.slot)
            self._by_id.clear()
            self._evictions += n
            return n

    def _evict_expired_locked(self, now: float) -> int:
        dead = [
            sid
            for sid, info in self._by_id.items()
            if now - info.last_used > self.ttl_s
        ]
        for sid in dead:
            self._free.append(self._by_id.pop(sid).slot)
        self._evictions += len(dead)
        return len(dead)

    # ----------------------------------------------------------------- stats
    @property
    def active(self) -> int:
        with self._lock:
            return len(self._by_id)

    @property
    def evictions(self) -> int:
        return self._evictions
