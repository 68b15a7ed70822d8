"""Batched tensor environments (Pendulum; DM-Control waits for a later slice)."""

from r2d2dpg_torch.envs.core import EnvSpec, Environment, TimeStep
from r2d2dpg_torch.envs.pendulum import Pendulum, PendulumState

__all__ = ["EnvSpec", "Environment", "Pendulum", "PendulumState", "TimeStep"]
