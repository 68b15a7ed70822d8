"""Environment API for batched tensor envs.

Port of ``r2d2dpg_tpu/envs/core.py``.  The JAX envs are pure functions
vmapped over a batch; the port's envs are batched from the start: a state
holds ``[E]`` tensors and ``step`` advances all E lanes at once.

Auto-reset contract (unchanged): ``step`` returns a ``TimeStep`` whose
``reset`` flag is 1 where the RETURNED observation begins a new episode;
``reward``/``discount`` describe the transition taken before any auto-reset.
Random numbers come from a draws object (``training/draws.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Protocol, Tuple

import torch

EnvState = Any


@dataclasses.dataclass(frozen=True)
class TimeStep:
    """One batched env step's outputs (leaves ``[E, ...]``)."""

    obs: torch.Tensor
    reward: torch.Tensor
    discount: torch.Tensor
    reset: torch.Tensor


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    """Static env metadata."""

    name: str
    obs_shape: Tuple[int, ...]
    action_dim: int
    action_min: float = -1.0
    action_max: float = 1.0
    episode_length: int = 1000
    pixels: bool = False


class Environment(Protocol):
    """Batched environment protocol."""

    spec: EnvSpec

    def reset(self, num_envs: int, draws) -> Tuple[EnvState, TimeStep]:
        """Fresh episodes -> (state, first TimeStep with reset=1, reward=0)."""
        ...

    def step(
        self, state: EnvState, action: torch.Tensor, draws
    ) -> Tuple[EnvState, TimeStep]:
        """Advance every lane one step, auto-resetting finished episodes."""
        ...
