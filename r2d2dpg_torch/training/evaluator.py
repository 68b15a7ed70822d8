"""Deterministic evaluation rollouts (noise-free policy).

Port of ``r2d2dpg_tpu/training/evaluator.py``: the return of the
deterministic policy mu(s), the number BASELINE.md's learning bars are
scored on.  ``num_envs`` fresh episodes run side by side for
``env.spec.episode_length`` steps with no exploration noise.  A reward
counts while its env is ``alive``, and an env retires at its first reset
(the reward of a step belongs to the episode live before any auto-reset).

The JAX evaluator is one jitted ``lax.scan``; the port steps a Python loop
over torch ops.  Random numbers (the envs' start states) come from a draws
object (``training/draws.py``), so a test can hand it the JAX draws.
"""

from __future__ import annotations

from typing import Dict

import torch

from r2d2dpg_torch.envs.core import Environment
from r2d2dpg_torch.models.actor_critic import ActorNet, Params


class Evaluator:
    """Rolls ``num_envs`` noise-free episodes and reports their returns.

    ``env`` is an instance of its own, separate from the training fleet.
    """

    def __init__(self, env: Environment, actor: ActorNet, num_envs: int = 10):
        self.env = env
        # A host-pool env labels its metrics by role, so the eval fleet's
        # step latencies stay apart from the training pool's.
        if hasattr(env, "set_role"):
            env.set_role("eval")
        self.actor = actor
        self.num_envs = num_envs

    @torch.no_grad()
    def run(self, actor_params: Params, draws) -> Dict[str, float]:
        """Mean/min/max deterministic return over the eval fleet."""
        env, e = self.env, self.num_envs
        env_state, ts = env.reset(e, draws)
        obs, reset = ts.obs, ts.reset
        carry = self.actor.initial_carry(e, obs.device)
        alive = torch.ones(e, device=obs.device)
        ep_ret = torch.zeros(e, device=obs.device)
        for _ in range(env.spec.episode_length):
            action, carry = self.actor.apply_params(actor_params, obs, carry, reset)
            env_state, ts = env.step(env_state, action, draws)
            ep_ret = ep_ret + ts.reward * alive
            alive = alive * (1.0 - ts.reset)
            obs, reset = ts.obs, ts.reset
        # An episode still alive after episode_length steps counts with its
        # partial return (a lower bound).
        mean, lo, hi = torch.stack([ep_ret.mean(), ep_ret.min(), ep_ret.max()]).tolist()
        return {"eval_return_mean": mean, "eval_return_min": lo, "eval_return_max": hi}
