"""The stand-in environment's dynamics, in numpy alone.

A frozen copy of the port's host stand-in (walker-walk's spec: obs 24,
action 6, bounds +-1, 500-step episodes), so that the benchmark's traffic
stays what it was when the benchmark was written.  The reference and the
traffic both use it; only ``drivers/standin_env.py`` plugs it into the
program.

Per lane: ``obs' = tanh(obs A + clip(act) B)`` and ``reward = (1 +
tanh(obs' w)) / 2 - 0.1 mean(act^2)``, with ``A``, ``B`` and ``w`` drawn
from ``seed``.  A lane's episode ends after ``episode_length`` steps (a
truncation: the discount stays 1) and the lane restarts from a start
state drawn from its own generator, seeded at ``reset``.
"""

from __future__ import annotations

import numpy as np


class StandIn:
    def __init__(self, seed: int, obs_dim: int = 24, action_dim: int = 6,
                 episode_length: int = 500):
        rng = np.random.default_rng(seed)
        self.a = (rng.standard_normal((obs_dim, obs_dim)) / np.sqrt(obs_dim)).astype(np.float32)
        self.b = (rng.standard_normal((action_dim, obs_dim)) / np.sqrt(action_dim)).astype(np.float32)
        self.w = (rng.standard_normal(obs_dim) / np.sqrt(obs_dim)).astype(np.float32)
        self.obs_dim, self.action_dim = obs_dim, action_dim
        self.episode_length = episode_length
        self.obs = self.t = None
        self.rngs: list = []

    def _start(self, i: int) -> np.ndarray:
        return self.rngs[i].uniform(-1.0, 1.0, (self.obs_dim,)).astype(np.float32)

    def reset(self, seeds) -> np.ndarray:
        """Fresh episodes on ``len(seeds)`` lanes; returns the first obs ``[E, obs]``."""
        self.rngs = [np.random.default_rng(int(s)) for s in seeds]
        self.obs = np.stack([self._start(i) for i in range(len(self.rngs))])
        self.t = np.zeros(len(self.rngs), np.int64)
        return self.obs.copy()

    def step(self, actions: np.ndarray):
        """All lanes: ``(obs', reward, discount, done)``; ``obs'`` is the next
        episode's start state where ``done``."""
        act = np.clip(np.asarray(actions, np.float32), -1.0, 1.0)
        nxt = np.tanh(self.obs @ self.a + act @ self.b).astype(np.float32)
        reward = ((1.0 + np.tanh(nxt @ self.w)) * 0.5
                  - 0.1 * (act * act).mean(axis=1)).astype(np.float32)
        self.t += 1
        done = self.t >= self.episode_length
        for i in np.nonzero(done)[0]:
            nxt[i] = self._start(i)
            self.t[i] = 0
        self.obs = nxt
        return nxt.copy(), reward, np.ones_like(reward), done.astype(np.float32)

    def step_lane(self, i: int, action: np.ndarray):
        """One lane: ``(obs', done)``, the same dynamics as ``step``."""
        act = np.clip(np.asarray(action, np.float32), -1.0, 1.0)
        nxt = np.tanh(self.obs[i] @ self.a + act @ self.b).astype(np.float32)
        self.t[i] += 1
        done = bool(self.t[i] >= self.episode_length)
        if done:
            nxt = self._start(i)
            self.t[i] = 0
        self.obs[i] = nxt
        return nxt.copy(), done
