"""Batched tensor Pendulum-v1 (gymnasium classic-control dynamics).

Port of ``r2d2dpg_tpu/envs/pendulum.py``: g=10, m=1, l=1, dt=0.05, torque in
[-2, 2], reward ``-(theta^2 + 0.1*thdot^2 + 0.001*u^2)``, 200-step episodes
ending by truncation only (``discount`` stays 1; the step carrying
``reset=1`` marks the truncation boundary).  Actions are canonical [-1, 1]
and rescaled internally.

Every step draws a fresh start state for all lanes, as the JAX env does,
and keeps it only where an episode ended.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from r2d2dpg_torch.device import resolve_device
from r2d2dpg_torch.envs.core import EnvSpec, TimeStep


@dataclasses.dataclass(frozen=True)
class PendulumState:
    theta: torch.Tensor  # [E]
    thdot: torch.Tensor  # [E]
    t: torch.Tensor  # [E] int32 step count within the episode


def _angle_normalize(x: torch.Tensor) -> torch.Tensor:
    return ((x + math.pi) % (2.0 * math.pi)) - math.pi


class Pendulum:
    """Pendulum-v1 over E lanes on one device."""

    MAX_TORQUE = 2.0
    MAX_SPEED = 8.0
    DT = 0.05
    G = 10.0

    def __init__(self, episode_length: int = 200, device=None):
        self.device = resolve_device(device)
        self.spec = EnvSpec(
            name="Pendulum-v1",
            obs_shape=(3,),
            action_dim=1,
            action_min=-self.MAX_TORQUE,
            action_max=self.MAX_TORQUE,
            episode_length=episode_length,
        )

    @staticmethod
    def _obs(s: PendulumState) -> torch.Tensor:
        return torch.stack([torch.cos(s.theta), torch.sin(s.theta), s.thdot], dim=-1)

    def _init_state(self, n: int, draws) -> PendulumState:
        return PendulumState(
            theta=draws.uniform((n,), -math.pi, math.pi),
            thdot=draws.uniform((n,), -1.0, 1.0),
            t=torch.zeros(n, dtype=torch.int32, device=self.device),
        )

    def reset(self, num_envs: int, draws) -> Tuple[PendulumState, TimeStep]:
        s = self._init_state(num_envs, draws)
        ones = torch.ones(num_envs, device=self.device)
        ts = TimeStep(
            obs=self._obs(s),
            reward=torch.zeros(num_envs, device=self.device),
            discount=ones,
            reset=ones.clone(),
        )
        return s, ts

    def step(
        self, state: PendulumState, action: torch.Tensor, draws
    ) -> Tuple[PendulumState, TimeStep]:
        u = action[..., 0].clamp(-1.0, 1.0) * self.MAX_TORQUE
        th, thdot = state.theta, state.thdot
        cost = _angle_normalize(th) ** 2 + 0.1 * thdot**2 + 0.001 * u**2

        newthdot = thdot + (
            3.0 * self.G / 2.0 * torch.sin(th) + 3.0 * u
        ) * self.DT
        newthdot = newthdot.clamp(-self.MAX_SPEED, self.MAX_SPEED)
        newth = th + newthdot * self.DT
        t = state.t + 1

        done = t >= self.spec.episode_length
        fresh = self._init_state(th.shape[0], draws)
        nxt = PendulumState(
            theta=torch.where(done, fresh.theta, newth),
            thdot=torch.where(done, fresh.thdot, newthdot),
            t=torch.where(done, fresh.t, t),
        )
        ts = TimeStep(
            obs=self._obs(nxt),
            reward=-cost,
            discount=torch.ones_like(cost),  # truncation, not termination
            reset=done.to(torch.float32),
        )
        return nxt, ts
