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

import numpy as np
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


class HostUpload:
    """The host-to-device half of a host-stepped env's step.

    ``upload(obs, reward, discount, reset)`` packs one step's numpy results
    into one host buffer and makes one copy of it to ``device``; the
    returned ``TimeStep`` holds views of that one device buffer.  On a card
    the host buffers are pinned and the copy is asynchronous on the current
    stream, so a ring of them takes turns: a buffer is written again only
    after the event recorded behind its last copy has passed, and a copy
    never reads a buffer the host is refilling.  On the CPU the arrays
    become tensors as they are (the pools return fresh arrays every step).
    """

    RING = 4

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._ring: list = []  # [pinned uint8 buffer, event or None]
        self._next = 0

    def upload(self, obs, reward, discount, reset) -> TimeStep:
        if self.device.type != "cuda":
            return TimeStep(*(torch.from_numpy(np.ascontiguousarray(x))
                              for x in (obs, reward, discount, reset)))
        e = obs.shape[0]
        n_obs = -(-obs.nbytes // 4) * 4  # the float tail starts 4-aligned
        nbytes = n_obs + 3 * e * 4
        if not self._ring or self._ring[0][0].numel() != nbytes:
            self._ring = [[torch.empty(nbytes, dtype=torch.uint8, pin_memory=True), None]
                          for _ in range(self.RING)]
        slot = self._ring[self._next]
        self._next = (self._next + 1) % self.RING
        buf, event = slot
        if event is not None:
            event.synchronize()  # the last copy out of this buffer is done
        host = buf.numpy()
        host[:obs.nbytes] = np.ascontiguousarray(obs).reshape(-1).view(np.uint8)
        host[n_obs:].view(np.float32)[:] = np.concatenate(
            [np.asarray(x, np.float32).reshape(-1) for x in (reward, discount, reset)])
        dev = buf.to(self.device, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record()
        dtype = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.uint8): torch.uint8}[obs.dtype]
        tail = dev[n_obs:].view(torch.float32).view(3, e)
        return TimeStep(
            obs=dev[:obs.nbytes].view(dtype).view(obs.shape),
            reward=tail[0], discount=tail[1], reset=tail[2],
        )
