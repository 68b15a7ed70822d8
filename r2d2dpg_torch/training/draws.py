"""The one object every random draw of the trainer goes through.

The JAX trainer splits ``jax.random`` keys; the port draws from one
``torch.Generator`` instead.  The two give different numbers from the same
seed, so a parity test hands the port a ``ReplayDraws`` that returns, in
order, the numbers the JAX program drew.

Per collect step the trainer draws, in this order: the exploration
normal ``[E, A]`` (gaussian or OU noise only), then the env's fresh start
state (Pendulum: theta ``[E]``, then thdot ``[E]``; a DM-Control host env
draws only at reset, its ``[E]`` integer seeds).  Per learner step it
draws the sampling uniforms ``[B]``, then, with target-policy smoothing on
(``target_policy_sigma > 0``), the smoothing normal ``[U + n, B, A]``
(time-major; JAX draws it from ``fold_in(key, 1)`` of the same learner
step's key).

With ``_learn_many(prefetch=True)`` (the pipelined drain) the order of a
phase's K learner steps is: uniforms 0; then for each step k, uniforms
k+1 (for k < K-1 only), then step k's smoothing normal (when on).  The
JAX scan draws batch k from ``keys[k]`` in both branches, so a parity test
feeds ``uniform(keys[0]), uniform(keys[1]), normal(fold_in(keys[0], 1)),
uniform(keys[2]), ...``; the JAX scan's extra trailing sample after the
last update has no counterpart here.

In the pipelined executor the collector keeps the state's draws and the
learner gets a second ``Draws`` (``training/pipeline.py``, ``split_state``
states the rule), so two threads never draw from one generator.

The per-rank rule of the data-parallel trainers (``parallel/``): a rank
that must draw its own numbers (``SPMDTrainer``: its env lanes' noise and
resets, its local batch) continues on ``draws.fold(rank)`` after the
replicated init draws.  Rank 0 keeps the stream itself, so a world of one
draws exactly what the plain trainer draws; rank ``r > 0`` gets a fresh
generator seeded ``fold_seed(seed, r)``.  JAX folds the rank into every
phase's key (``fold_in(key, axis_index)``, which changes rank 0's draws
too); a stream is folded once.  ``ReplayDraws.fold`` is the identity: a
test's recorded numbers are already the rank's.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Sequence

import torch


def fold_seed(seed: int, rank: int) -> int:
    """Rank ``rank``'s seed derived from ``seed`` (``seed`` itself at rank 0)."""
    return (seed + rank * 0x9E3779B97F4A7C15) % 2**63


class Draws:
    """Draws from a seeded ``torch.Generator`` on ``device``."""

    def __init__(self, seed: int, device: torch.device):
        self.seed = seed
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def normal(self, shape: Sequence[int]) -> torch.Tensor:
        """Standard normal float32."""
        return torch.randn(
            tuple(shape), generator=self.generator, device=self.device
        )

    def uniform(
        self, shape: Sequence[int], low: float = 0.0, high: float = 1.0
    ) -> torch.Tensor:
        """Uniform float32 in ``[low, high)``."""
        u = torch.rand(tuple(shape), generator=self.generator, device=self.device)
        return u * (high - low) + low

    def randint(self, shape: Sequence[int], low: int, high: int) -> torch.Tensor:
        """Uniform int64 in ``[low, high)`` (a host env's reset seeds)."""
        return torch.randint(
            low, high, tuple(shape), generator=self.generator, device=self.device
        )

    def fold(self, rank: int) -> "Draws":
        """Rank ``rank``'s own stream: this one at rank 0, else a fresh
        generator seeded ``fold_seed(seed, rank)``."""
        return self if rank == 0 else Draws(fold_seed(self.seed, rank), self.device)


class ReplayDraws:
    """Returns given tensors in order, checking each one's shape.

    ``uniform`` ignores ``low``/``high``: the recorded values are already the
    final draws (the JAX program's scaled uniforms).
    """

    def __init__(self, values: Iterable[torch.Tensor]):
        self._queue = deque(values)

    def _next(self, shape) -> torch.Tensor:
        if not self._queue:
            raise RuntimeError("ReplayDraws exhausted")
        x = self._queue.popleft()
        if tuple(x.shape) != tuple(shape):
            raise ValueError(
                f"ReplayDraws: next value has shape {tuple(x.shape)}, "
                f"caller asked for {tuple(shape)}"
            )
        return x

    def normal(self, shape: Sequence[int]) -> torch.Tensor:
        return self._next(shape)

    def uniform(
        self, shape: Sequence[int], low: float = 0.0, high: float = 1.0
    ) -> torch.Tensor:
        del low, high
        return self._next(shape)

    def randint(self, shape: Sequence[int], low: int, high: int) -> torch.Tensor:
        del low, high
        return self._next(shape)

    def remaining(self) -> int:
        return len(self._queue)

    def fold(self, rank: int) -> "ReplayDraws":
        del rank
        return self
