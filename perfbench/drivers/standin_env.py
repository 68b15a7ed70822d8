"""The stand-in's numpy dynamics (``traffic/standin.py``) plugged into the
program as a host-stepped env: the interface of the port's DM-Control host
env, with one pinned upload a step through the port's ``HostUpload``."""

from __future__ import annotations

import torch

from r2d2dpg_torch.envs.core import EnvSpec, HostUpload
from r2d2dpg_torch.envs.dmc_host import SEED_HIGH, DMCState, fetch_actions

from perfbench.traffic.standin import StandIn


class StandInEnv:
    batched = True

    def __init__(self, seed: int, device, obs_shape=(24,), obs_dtype="float32",
                 action_dim: int = 6, episode_length: int = 500):
        self.device = torch.device(device)
        self.spec = EnvSpec(name="perfbench-stand-in", obs_shape=tuple(obs_shape),
                            action_dim=action_dim, episode_length=episode_length,
                            pixels=len(obs_shape) == 3)
        self.seed, self.episode_length = seed, episode_length
        self.dynamics = None  # made at reset: the stand-in has flat observations only
        self.role = "train"
        self._upload = HostUpload(self.device)

    def set_role(self, role: str) -> None:
        self.role = role

    def reset(self, num_envs: int, draws):
        if self.spec.pixels:
            raise ValueError("the stand-in env has flat observations only")
        self.dynamics = StandIn(self.seed, self.spec.obs_shape[0], self.spec.action_dim,
                                self.episode_length)
        seeds = draws.randint((num_envs,), 0, SEED_HIGH).cpu().numpy()
        obs = self.dynamics.reset(seeds)
        zeros = obs[:, 0] * 0
        ts = self._upload.upload(obs, zeros, zeros + 1, zeros + 1)
        return DMCState(token=torch.zeros((), dtype=torch.int32, device=self.device)), ts

    def step(self, state, action, draws):
        del draws
        return state, self._upload.upload(*self.dynamics.step(fetch_actions(action)))
