"""Sharded prioritized replay at the ingest edge: host-side numpy shards.

Port of ``r2d2dpg_tpu/replay/sharded.py`` (numpy there too; copied so the
port imports nothing of the JAX package).  In-network experience sampling
(PAPERS.md 2110.13506) keeps replay in N shards where experience arrives,
each a slice of capacity with its own priority structure, and the learner
PULLS training-ready batches (``fleet/sampler.py`` owns the routing, the
frames and the pull loop).

**Two-level sampling.**  The central proportional distribution draws slot
``i`` with probability ``p_i^alpha / sum_j p_j^alpha``.  Factored by
shard, ``P(i in s) = (S_s / S_total) * (p_i^alpha / S_s)`` with ``S_s``
the shard's sum, so a multinomial over the shards' sums
(``shard_quotas``) followed by a within-shard proportional draw is the
central distribution exactly; the per-draw probability for importance
weights is ``(S_s / S_total) * within_prob`` (``combine_probs``).

**Write-back versioning.**  Every slot carries a monotone generation,
bumped when the ring overwrites it.  A sample hands out
``(slot, generation)`` pairs and a later priority write-back applies only
where the generation still matches.

**Types.**  A shard stores ``SequenceBatch`` leaves as numpy arrays, not
tensors: the port's ``SequenceBatch`` is typed as torch, but on this side
of the sampling boundary it is a container of numpy arrays, written by
ingest handler threads and read by the sampler.  Nothing here touches a
device or calls ``torch.from_numpy``; a decoded frame's read-only leaves
are copied into the ring, never kept.  The draws are numpy's
``Generator``, as in the JAX package, so the same adds and seed give the
same slots, generations and probabilities bit for bit.
"""

from __future__ import annotations

import dataclasses
import threading
import zlib
from typing import Any, Optional, Sequence

import numpy as np

from r2d2dpg_torch.obs.quality import PROVENANCE_ABSENT
from r2d2dpg_torch.obs.registry import get_registry
from r2d2dpg_torch.ops.priority import PRIORITY_EPS
from r2d2dpg_torch.replay.arena import SequenceBatch
from r2d2dpg_torch.tree import tree_map


def actor_code(actor_id: Any) -> int:
    """Slot-storable int64 code for a HELLO-authenticated actor id: a
    non-negative integer id maps to itself, any other id to its crc32.
    Never the ``PROVENANCE_ABSENT`` sentinel."""
    s = str(actor_id)
    if s.isdigit():
        return int(s)
    return int(zlib.crc32(s.encode("utf-8")))


@dataclasses.dataclass(frozen=True)
class ShardSample:
    """One shard's answer to a sample request (within-shard quantities).

    ``probs`` are within-shard probabilities (``p^alpha / S_s``);
    ``combine_probs`` turns them into the central per-draw probability.
    ``gens`` are the slots' generations at sample time (the write-back
    key).  ``behavior``/``collect``/``actors`` are the slots' quality
    provenance, ``PROVENANCE_ABSENT`` where unknown."""

    seq: SequenceBatch  # numpy leaves [n, L, ...]
    slots: np.ndarray  # [n] int64 shard-local slot indices
    gens: np.ndarray  # [n] int64 slot generations at sample time
    probs: np.ndarray  # [n] float64 within-shard probabilities
    behavior: Any = None  # [n] int64 behaviour param versions
    collect: Any = None  # [n] int64 collector phase clocks
    actors: Any = None  # [n] int64 authenticated actor codes


class ReplayShard:
    """One slice of replay capacity: a host-side prioritized ring.

    The feeding handler thread calls ``add``; the sampler calls
    ``sample``/``update_priorities``/the stat reads.  Every public method
    takes the shard's lock, so N shards take N concurrent writers.
    ``evict_cb(n)`` and ``evict_unsampled_cb(evicted, unsampled)`` are
    called under that lock when an add overwrites filled slots."""

    def __init__(
        self,
        capacity: int,
        *,
        alpha: float = 0.6,
        prioritized: bool = True,
        shard_id: int = 0,
        evict_cb=None,
        evict_unsampled_cb=None,
    ):
        if capacity < 1:
            raise ValueError("shard capacity must be >= 1")
        self.capacity = capacity
        self.alpha = alpha
        self.prioritized = prioritized
        self.shard_id = shard_id
        self._lock = threading.Lock()
        self._data = None  # numpy struct-of-arrays, allocated by the first add
        self._priority = np.zeros((capacity,), np.float64)  # raw; 0 = empty
        self._scaled = np.zeros((capacity,), np.float64)  # p^alpha (or 1.0)
        self._generation = np.zeros((capacity,), np.int64)
        self._behavior = np.full((capacity,), PROVENANCE_ABSENT, np.int64)
        self._collect = np.full((capacity,), PROVENANCE_ABSENT, np.int64)
        self._actor = np.full((capacity,), PROVENANCE_ABSENT, np.int64)
        self._ever_sampled = np.zeros((capacity,), bool)
        self._cursor = 0
        self.total_added = 0
        # Ring overwrites of filled slots (the backpressure that replaced
        # shedding) and how many of them were never sampled.
        self.evictions_total = 0
        self.evicted_unsampled_total = 0
        self._evict_cb = evict_cb
        self._evict_unsampled_cb = evict_unsampled_cb

    # ------------------------------------------------------------------ add
    def _alloc(self, seq: SequenceBatch) -> None:
        self._data = tree_map(
            lambda x: np.zeros((self.capacity,) + x.shape[1:], x.dtype),
            tree_map(np.asarray, seq),
        )

    def add(
        self,
        seq: SequenceBatch,
        priorities: Optional[np.ndarray],
        *,
        behavior: Optional[np.ndarray] = None,
        collect: Optional[np.ndarray] = None,
        actor: Optional[int] = None,
    ) -> int:
        """Ring-write B sequences at the cursor (FIFO overwrite).

        ``priorities=None`` enters at the shard's max priority so far,
        floor 1.0 (the central ``initial_priority="max"``).  Overwritten
        slots bump their generation.  ``actor`` is the feeding
        connection's HELLO-authenticated id code, never a payload claim.
        Returns B."""
        b = int(np.shape(seq.reward)[0])
        with self._lock:
            if self._data is None:
                self._alloc(seq)
            if priorities is None:
                entry = max(float(self._priority.max()), 1.0)
                prios = np.full((b,), entry, np.float64)
            else:
                prios = np.asarray(priorities, np.float64)
            prios = np.maximum(prios, PRIORITY_EPS)
            idx = (self._cursor + np.arange(b)) % self.capacity
            filled = self._priority[idx] > 0
            evicted = int(filled.sum())
            if evicted:
                unsampled = int((filled & ~self._ever_sampled[idx]).sum())
                self.evictions_total += evicted
                self.evicted_unsampled_total += unsampled
                if self._evict_cb is not None:
                    self._evict_cb(evicted)
                if self._evict_unsampled_cb is not None:
                    self._evict_unsampled_cb(evicted, unsampled)
            tree_map(lambda buf, new: buf.__setitem__(idx, new),
                     self._data, tree_map(np.asarray, seq))
            self._priority[idx] = prios
            self._scaled[idx] = prios**self.alpha if self.prioritized else 1.0
            self._generation[idx] += 1
            self._behavior[idx] = (
                PROVENANCE_ABSENT if behavior is None
                else np.asarray(behavior, np.int64))
            self._collect[idx] = (
                PROVENANCE_ABSENT if collect is None
                else np.asarray(collect, np.int64))
            self._actor[idx] = PROVENANCE_ABSENT if actor is None else int(actor)
            self._ever_sampled[idx] = False
            self._cursor = int((self._cursor + b) % self.capacity)
            self.total_added += b
        return b

    # --------------------------------------------------------------- sample
    def sample(self, n: int, rng: np.random.Generator) -> ShardSample:
        """Draw ``n`` sequences proportional to ``p^alpha`` within this
        shard (uniform over filled slots when unprioritized).  An empty
        shard raises ``ValueError`` (quotas weight empty shards at 0)."""
        with self._lock:
            if self._data is None or not (self._priority > 0).any():
                raise ValueError(
                    f"shard {self.shard_id} is empty; quotas must not "
                    f"route draws here"
                )
            scaled = self._scaled
            cdf = np.cumsum(scaled)
            # The total is the cumsum's last element, not scaled.sum():
            # pairwise summation can exceed it, and a draw in that gap
            # would searchsort past the end.  The clamp is to the last
            # FILLED slot, so an empty slot (generation 0) is never drawn.
            total = float(cdf[-1])
            u = rng.random(n) * total
            last_filled = int(np.flatnonzero(scaled)[-1])
            slots = np.minimum(np.searchsorted(cdf, u, side="right"), last_filled)
            probs = scaled[slots] / max(total, 1e-300)
            seq = tree_map(lambda buf: buf[slots], self._data)
            gens = self._generation[slots].copy()
            behavior = self._behavior[slots].copy()
            collect = self._collect[slots].copy()
            actors = self._actor[slots].copy()
            self._ever_sampled[slots] = True
        return ShardSample(
            seq=seq,
            slots=slots.astype(np.int64),
            gens=gens,
            probs=probs.astype(np.float64),
            behavior=behavior,
            collect=collect,
            actors=actors,
        )

    # ------------------------------------------------------- priority update
    def update_priorities(
        self, slots: np.ndarray, gens: np.ndarray, priorities: np.ndarray
    ) -> int:
        """Learner TD-error write-back, applied only where the slot's
        generation still equals ``gens``; duplicates resolve last write
        wins.  Out-of-range slots refuse the whole update.  Returns how
        many entries applied."""
        slots = np.asarray(slots, np.int64)
        gens = np.asarray(gens, np.int64)
        prios = np.maximum(np.asarray(priorities, np.float64), PRIORITY_EPS)
        if slots.size and not (
            0 <= int(slots.min()) and int(slots.max()) < self.capacity
        ):
            raise ValueError(
                f"write-back slots outside shard capacity {self.capacity}"
            )
        with self._lock:
            fresh = self._generation[slots] == gens
            idx = slots[fresh]
            self._priority[idx] = prios[fresh]
            self._scaled[idx] = (
                prios[fresh] ** self.alpha if self.prioritized else 1.0
            )
            return int(fresh.sum())

    # ------------------------------------------------------------------ stats
    def occupancy(self) -> int:
        with self._lock:
            return int((self._priority > 0).sum())

    def priority_sum(self) -> float:
        """Raw priority sum (the ``r2d2dpg_replay_shard_priority_sum`` gauge)."""
        with self._lock:
            return float(self._priority.sum())

    def scaled_sum(self) -> float:
        """The quota weight this shard advertises: ``sum p^alpha``."""
        with self._lock:
            return float(self._scaled.sum())


def shard_instruments():
    """The per-shard registry instruments, one definition wherever a shard
    lives (in the learner, in a shard process, or mirrored by the learner
    from a remote one): ``(priority_sum, occupancy, evictions)``, each
    labelled ``shard``."""
    reg = get_registry()
    return (
        reg.gauge("r2d2dpg_replay_shard_priority_sum",
                  "raw priority sum of one replay shard (the quota weight is "
                  "sum p^alpha, ReplayShard.scaled_sum)", labelnames=("shard",)),
        reg.gauge("r2d2dpg_replay_shard_occupancy", "filled slots of one replay shard",
                  labelnames=("shard",)),
        reg.counter("r2d2dpg_replay_shard_evictions_total",
                    "filled replay-shard slots FIFO-overwritten by the ring "
                    "(re-collectable experience recycled before it was sampled)",
                    labelnames=("shard",)),
    )


def shard_quotas(
    scaled_sums: Sequence[float], n: int, rng: np.random.Generator
) -> np.ndarray:
    """Level 1 of two-level sampling: how many of ``n`` draws each shard
    serves, multinomial over the advertised ``sum p^alpha``.  Empty shards
    get 0; an all-empty fleet raises."""
    w = np.asarray(scaled_sums, np.float64)
    if (w < 0).any():
        raise ValueError("negative shard priority sum")
    total = w.sum()
    if total <= 0:
        raise ValueError("all shards empty: nothing to sample")
    return rng.multinomial(n, w / total)


def combine_probs(
    within_probs: np.ndarray, shard_sum: float, total_sum: float
) -> np.ndarray:
    """The per-draw probability of the realized two-stage draw,
    ``(S_s / S_total) * within_prob``, float64.

    ``shard_sum``/``total_sum`` are the quota-time snapshot and
    ``within_probs`` the sample-time normalization: under concurrent adds
    the product is exactly the probability with which each slot was drawn,
    so neither factor is moved to the other's moment."""
    return np.asarray(within_probs, np.float64) * (
        shard_sum / max(total_sum, 1e-300)
    )
