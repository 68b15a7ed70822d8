"""Device-resident prioritized sequence replay arena.

Port of ``r2d2dpg_tpu/replay/arena.py``: a struct-of-arrays of
preallocated device buffers with ring semantics.

- ``add``: B sequences written at the ring cursor (FIFO overwrite).
- ``sample``: proportional sampling by inverse CDF over a ``cumsum`` of
  ``p^alpha`` (plain torch ops, as XLA did it in the JAX package), or
  uniform over the valid prefix.
- ``update_priorities``: the learner's write-back through the priority
  scatter kernel (``ops/scatter.py``).

Unlike the JAX arena, whose functions return fresh arrays, the port updates
its buffers IN PLACE: ``add`` copies into the preallocated buffers and
``update_priorities`` lets the kernel write only the B sampled slots, so no
``[capacity]``-sized copy is made per call.  Both still return the state
for symmetry with the JAX call sites.

The staged and fleet methods (``add_staged``, ``stack_staged``,
``staged_meta``) and ``per_shard_occupancy`` wait for later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from r2d2dpg_torch.ops.priority import PRIORITY_EPS
from r2d2dpg_torch.ops.scatter import priority_scatter
from r2d2dpg_torch.tree import tree_map

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
