"""Device-resident prioritized sequence replay arena.

Port of ``r2d2dpg_tpu/replay/arena.py``: a struct-of-arrays of
preallocated device buffers with ring semantics.

- ``add``: B sequences written at the ring cursor (FIFO overwrite).
- ``sample``: proportional sampling by inverse CDF over a ``cumsum`` of
  ``p^alpha`` (plain torch ops, as XLA did it in the JAX package), or
  uniform over the valid prefix.
- ``update_priorities``: the learner's write-back through the priority
  scatter kernel (``ops/scatter.py``).

- ``add_staged``: the pipelined executor's drain path: a collect phase's
  ``StagedSequences`` (``stack_staged`` concatenates several), through
  ``add`` with the ``staged_meta`` stamp, under a single-writer claim.

Unlike the JAX arena, whose functions return fresh arrays, the port updates
its buffers IN PLACE: ``add`` copies into the preallocated buffers and
``update_priorities`` lets the kernel write only the B sampled slots, so no
``[capacity]``-sized copy is made per call.  Both still return the state
for symmetry with the JAX call sites.

The arena publishes four registry gauges (``r2d2dpg_replay_capacity``,
``_occupancy``, ``_priority_sum``, ``_sequences_added``); the loops feed
them from their log fetch through ``observe_state_scalars``.
``per_shard_occupancy`` waits for the multi-device slice.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Optional, Sequence

import torch

from r2d2dpg_torch.obs.registry import get_registry
from r2d2dpg_torch.ops.priority import PRIORITY_EPS
from r2d2dpg_torch.ops.scatter import priority_scatter
from r2d2dpg_torch.tree import tree_leaves, tree_map

# Slot metadata sentinel for "provenance unknown" (the JAX package's
# obs/quality.py value, copied so the port imports nothing of it).
PROVENANCE_ABSENT = -1


@dataclasses.dataclass(frozen=True)
class SequenceBatch:
    """A batch of stored sequences, batch-major ``[B, L, ...]``.

    ``carries`` holds each net's initial recurrent state (window start):
    ``{"actor": carry, "critic": carry}``, leaves ``[B, H]`` (``()`` for
    feedforward nets).
    """

    obs: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    discount: torch.Tensor
    reset: torch.Tensor
    carries: Dict[str, Any]


@dataclasses.dataclass
class ArenaState:
    """Replay storage; ``add``/``update_priorities`` mutate it in place."""

    data: SequenceBatch  # leaves [capacity, L, ...] / carries [capacity, H]
    priority: torch.Tensor  # [capacity] float32 raw priorities; 0 marks empty
    cursor: int  # next write position
    total_added: int  # monotone count of sequences ever added
    # [capacity, 2] int32: column 0 the behaviour param version, column 1 the
    # learner step at arena entry; PROVENANCE_ABSENT where unknown.
    meta: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SampleResult:
    batch: SequenceBatch
    indices: torch.Tensor  # [B] int64 slot indices, for priority write-back
    probs: torch.Tensor  # [B] sampling probabilities (1/N for uniform)


@dataclasses.dataclass(frozen=True)
class StagedSequences:
    """B emitted sequences in flight from a collector to the learner.

    The pipelined executor's staging-queue payload (``training/pipeline.py``).
    ``priorities`` is ``None`` when the learner ranks the sequences at drain
    time with its current nets (the default), or ``[B]`` float32 when the
    producer ranked them.  ``behavior_version`` / ``collect_id`` are the
    quality provenance (``[B]`` int64: the behaviour param version, the
    collector's phase clock), ``None`` when unknown.
    """

    seq: SequenceBatch  # leaves [B, L, ...] / carries [B, ...]
    priorities: Any = None  # [B] float32, or None (ranked at drain)
    behavior_version: Any = None  # [B] int64, or None
    collect_id: Any = None  # [B] int64, or None


def staged_nbytes(staged: StagedSequences) -> int:
    """Total tensor bytes of a staged batch (the ``arena_add`` span's size)."""
    return int(sum(x.numel() * x.element_size() for x in tree_leaves(staged)))


def stack_staged(batches: Sequence[StagedSequences]) -> StagedSequences:
    """Concatenate staged batches along B (a coalesced drain's payload).

    One batch passes through untouched.  Mixing resolved and unresolved
    priorities raises; provenance present on only some batches is dropped
    (the quality folds disarm) rather than refused."""
    if not batches:
        raise ValueError("stack_staged needs at least one batch")
    if len(batches) == 1:
        return batches[0]
    resolved = [b.priorities is not None for b in batches]
    if any(resolved) != all(resolved):
        raise ValueError(
            "stack_staged: cannot mix resolved and unresolved priorities"
        )

    def cat(parts):
        if all(p is not None for p in parts):
            return torch.cat(list(parts))
        return None

    return StagedSequences(
        seq=tree_map(lambda *xs: torch.cat(xs), *[b.seq for b in batches]),
        priorities=cat([b.priorities for b in batches]),
        behavior_version=cat([b.behavior_version for b in batches]),
        collect_id=cat([b.collect_id for b in batches]),
    )


class _StagedWriterClaim:
    """``with arena.staged_writer():``, a loud refusal on overlap."""

    def __init__(self, lock):
        self._lock = lock

    def __enter__(self):
        if not self._lock.acquire(blocking=False):
            raise RuntimeError(
                "ReplayArena.add_staged is single-writer: another thread is "
                "mid-add on this arena.  Route producers through a staging "
                "queue drained by one thread"
            )
        return self

    def __exit__(self, *exc):
        self._lock.release()


class ReplayArena:
    """Static replay configuration + the state-transition functions."""

    def __init__(
        self, capacity: int, *, prioritized: bool = True, alpha: float = 0.6
    ):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.prioritized = prioritized
        self.alpha = alpha
        # Host-side gauges, fed from the loops' log fetch
        # (observe_state_scalars); registration is idempotent.
        reg = get_registry()
        self._obs_capacity = reg.gauge(
            "r2d2dpg_replay_capacity", "arena slot capacity (static)"
        )
        self._obs_capacity.set(float(capacity))
        self._obs_occupancy = reg.gauge(
            "r2d2dpg_replay_occupancy", "filled arena slots (min(added, cap))"
        )
        self._obs_priority_sum = reg.gauge(
            "r2d2dpg_replay_priority_sum",
            "sum of raw slot priorities (0 while empty)",
        )
        self._obs_added = reg.gauge(
            "r2d2dpg_replay_sequences_added",
            "monotone count of sequences ever added",
        )
        # The staged path's single-writer claim (re-entrant: a drain loop
        # may hold it around a call that claims it again).
        self._staged_writer_lock = threading.RLock()

    def observe_state_scalars(
        self, occupancy: float, priority_sum: float, total_added: float
    ) -> None:
        """Publish host-fetched arena scalars onto the registry (called on
        the log cadence with values from that cadence's one fetch)."""
        self._obs_occupancy.set(occupancy)
        self._obs_priority_sum.set(priority_sum)
        self._obs_added.set(total_added)

    # ------------------------------------------------------------------ init
    def init_state(self, example: SequenceBatch) -> ArenaState:
        """Preallocate buffers, on the example's device, from a batch ``[B, ...]``."""
        device = example.obs.device
        data = tree_map(
            lambda x: torch.zeros(
                (self.capacity,) + tuple(x.shape[1:]), dtype=x.dtype, device=device
            ),
            example,
        )
        return ArenaState(
            data=data,
            priority=torch.zeros(self.capacity, device=device),
            cursor=0,
            total_added=0,
            meta=torch.full(
                (self.capacity, 2), PROVENANCE_ABSENT, dtype=torch.int32, device=device
            ),
        )

    # ------------------------------------------------------------------- add
    def add(
        self,
        state: ArenaState,
        batch: SequenceBatch,
        priorities: torch.Tensor,
        meta: Optional[torch.Tensor] = None,
    ) -> ArenaState:
        """Write B new sequences at the ring cursor, in place.

        ``meta`` (``[B, 2]``) is the quality stamp; ``None`` writes
        ``PROVENANCE_ABSENT`` rather than inheriting the evicted slot's.
        """
        b = priorities.shape[0]
        device = state.priority.device
        idx = (state.cursor + torch.arange(b, device=device)) % self.capacity

        def put(buf, new):
            buf.index_copy_(0, idx, new.to(buf.dtype))
            return buf

        tree_map(put, state.data, batch)
        put(state.priority, priorities.clamp_min(PRIORITY_EPS))
        if meta is None:
            meta = torch.full((b, 2), PROVENANCE_ABSENT, dtype=torch.int32)
        put(state.meta, meta.to(device))
        state.cursor = (state.cursor + b) % self.capacity
        state.total_added += b
        return state

    def staged_meta(
        self, staged: StagedSequences, stamp: Optional[int] = None
    ) -> Optional[torch.Tensor]:
        """The ``add`` meta stamp ``[B, 2]`` int32 of a staged batch: column
        0 the staged behaviour version (absent: the sentinel), column 1
        ``stamp``, the owning learner's step at entry.  ``None`` when
        neither is known (``add`` then writes the sentinel)."""
        if staged.behavior_version is None and stamp is None:
            return None
        b = staged.seq.reward.shape[0]
        device = staged.seq.reward.device

        def col(x):
            if x is None:
                return torch.full((b,), PROVENANCE_ABSENT, dtype=torch.int32,
                                  device=device)
            x = torch.as_tensor(x, device=device).to(torch.int32)
            return x.expand(b) if x.dim() == 0 else x

        return torch.stack([col(staged.behavior_version), col(stamp)], dim=1)

    def add_staged(
        self,
        state: ArenaState,
        staged: StagedSequences,
        stamp: Optional[int] = None,
    ) -> ArenaState:
        """Absorb a staged batch in place (the pipelined drain's add).

        ``staged.priorities`` must be resolved by the caller (the drain
        ranks with ``Trainer._initial_priorities``): the arena has no nets.
        Single writer: the add runs under ``staged_writer``, so a second
        thread adding to this arena at the same time raises instead of
        interleaving its rows with this one's."""
        if staged.priorities is None:
            raise ValueError(
                "add_staged needs resolved priorities; compute them "
                "(e.g. Trainer._initial_priorities) before absorbing"
            )
        with self.staged_writer():
            return self.add(
                state, staged.seq, staged.priorities,
                meta=self.staged_meta(staged, stamp),
            )

    def staged_writer(self) -> _StagedWriterClaim:
        """Non-blocking claim of the one staged-writer slot (a context
        manager); another thread's overlapping claim raises.  Re-entrant
        on the holding thread."""
        return _StagedWriterClaim(self._staged_writer_lock)

    # ------------------------------------------------------------------ size
    def size(self, state: ArenaState) -> int:
        return min(state.total_added, self.capacity)

    # ---------------------------------------------------------------- sample
    def sample(
        self,
        state: ArenaState,
        batch_size: int,
        *,
        generator: Optional[torch.Generator] = None,
        uniforms: Optional[torch.Tensor] = None,
    ) -> SampleResult:
        """Draw ``batch_size`` sequences (proportional-prioritized or uniform).

        ``uniforms`` (``[batch_size]`` in [0, 1)) replaces the generator's draw,
        so a test can feed the JAX package's own draws.  The caller keeps the
        arena non-empty (the trainer's warm-up schedule does).
        """
        device = state.priority.device
        if uniforms is None:
            uniforms = torch.rand(batch_size, generator=generator, device=device)
        size = self.size(state)
        if self.prioritized:
            # p^alpha over valid slots (empty slots have priority 0).
            scaled = torch.where(
                state.priority > 0.0, state.priority**self.alpha, 0.0
            )
            total = scaled.sum()
            cdf = torch.cumsum(scaled, dim=0)
            indices = torch.searchsorted(cdf, uniforms * total, right=True).clamp(
                0, self.capacity - 1
            )
            probs = scaled[indices] / total.clamp_min(1e-12)
        else:
            n = max(size, 1)
            indices = (uniforms * n).long().clamp(0, n - 1)
            probs = torch.full((batch_size,), 1.0 / n, device=device)
        batch = tree_map(lambda buf: buf[indices], state.data)
        return SampleResult(batch=batch, indices=indices, probs=probs)

    # ------------------------------------------------------- priority update
    def update_priorities(
        self, state: ArenaState, indices: torch.Tensor, priorities: torch.Tensor
    ) -> ArenaState:
        """Learner write-back of fresh sequence priorities, in place (the kernel)."""
        values = priorities.clamp_min(PRIORITY_EPS).contiguous()
        priority_scatter(state.priority, indices.contiguous(), values)
        return state
