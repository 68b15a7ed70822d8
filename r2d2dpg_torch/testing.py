"""Inputs shared by the port's tests and ``chip_smoke.py``.

``scatter_case`` builds the priority-scatter inputs whose duplicates fall
inside one warp and across warps of the kernel's block, so the CPU tests
(against the JAX reference), the card tests and the chip smoke run hold the
kernel to the same patterns.  ``HostStandInEnv`` is a host-stepped env
with walker-walk's spec and fixed numpy dynamics, which drives the
host-pool trainer (``parallel/hybrid.py``) where there is no MuJoCo.
``count_collectives`` counts the ``torch.distributed`` collectives each
thread calls, which shows that the pipelined collector calls none.
"""

from __future__ import annotations

import collections
import contextlib
import threading

import numpy as np

SCATTER_PATTERNS = ("mixed", "repeat", "all_same", "out_of_range")
# "repeat" writes one slot at these j (those below B): within warp 0
# (0, 31), then the next warps (32, 95, 255); the last one must win.
REPEAT_AT = (0, 31, 32, 95, 255)


def scatter_case(pattern: str, capacity: int, b: int, seed: int):
    """numpy (priority [capacity] f32, indices [b] int64, values [b] f32).

    Every pattern starts from random in-range indices and distinct-looking
    values (so which duplicate won is visible), then:

    - ``mixed``: index ``b//2`` repeats index 0 and the last repeats index 1
      (the later one wins); indices 2 and 3 lie above and below the range;
    - ``repeat``: one slot at every ``REPEAT_AT`` position below ``b``;
    - ``all_same``: every index the same slot;
    - ``out_of_range``: every index outside ``[0, capacity)``, alternately
      above and below.
    """
    rng = np.random.default_rng(seed)
    prio = rng.uniform(0.1, 2.0, capacity).astype(np.float32)
    idx = rng.integers(0, capacity, b).astype(np.int64)
    vals = rng.uniform(3.0, 9.0, b).astype(np.float32)
    if pattern == "mixed":
        if b >= 2:
            idx[b // 2] = idx[0]
            idx[-1] = idx[1]
        if b >= 4:
            idx[2] = capacity + 5
            idx[3] = -1
    elif pattern == "repeat":
        idx[[j for j in REPEAT_AT if j < b]] = idx[0]
    elif pattern == "all_same":
        idx[:] = idx[0]
    elif pattern == "out_of_range":
        j = np.arange(b, dtype=np.int64)
        idx = np.where(j % 2 == 0, capacity + j, -1 - j)
    else:
        raise ValueError(f"unknown scatter pattern {pattern!r}")
    return prio, idx, vals


class HostStandInEnv:
    """A host-stepped env with ``DMCHostEnv``'s interface and walker-walk's
    spec (obs 24, act 6, bounds +-1, 500-step episodes), for running the
    host-pool trainer where there is no MuJoCo.

    Its step runs on the host in numpy: ``obs' = tanh(obs @ A + act @ B)``
    and ``reward = (1 + tanh(obs' @ w)) / 2 - 0.1 * mean(act**2)``, with
    ``A``, ``B`` and ``w`` fixed by ``seed``, so a wrong action or a wrong
    lane changes the data.  An episode ends after ``episode_length`` steps
    (a truncation: discount stays 1) and that env restarts from a start
    state drawn from its own generator, seeded by ``reset``'s integer
    draws.  It does no physics: a step costs microseconds, so a run shows
    the device half and the schedules, not physics hidden under learning.
    """

    batched = True

    def __init__(self, seed: int = 0, device=None, obs_dim: int = 24,
                 action_dim: int = 6, episode_length: int = 500):
        from r2d2dpg_torch.device import resolve_device
        from r2d2dpg_torch.envs.core import EnvSpec, HostUpload

        rng = np.random.default_rng(seed)
        self.a = (rng.standard_normal((obs_dim, obs_dim)) / np.sqrt(obs_dim)).astype(np.float32)
        self.b = (rng.standard_normal((action_dim, obs_dim)) / np.sqrt(action_dim)).astype(np.float32)
        self.w = (rng.standard_normal(obs_dim) / np.sqrt(obs_dim)).astype(np.float32)
        self.device = resolve_device(device)
        self.spec = EnvSpec(
            name="stand-in-walker-walk", obs_shape=(obs_dim,), action_dim=action_dim,
            action_min=-1.0, action_max=1.0, episode_length=episode_length,
        )
        self.role = "train"
        self._upload = HostUpload(self.device)
        self._obs = self._t = None
        self._rngs: list = []

    def set_role(self, role: str) -> None:
        self.role = role

    def _start(self, i: int) -> np.ndarray:
        return self._rngs[i].uniform(-1.0, 1.0, self.spec.obs_shape).astype(np.float32)

    def reset(self, num_envs: int, draws):
        import torch

        from r2d2dpg_torch.envs.dmc_host import SEED_HIGH, DMCState

        seeds = draws.randint((num_envs,), 0, SEED_HIGH).cpu().numpy()
        self._rngs = [np.random.default_rng(int(s)) for s in seeds]
        self._obs = np.stack([self._start(i) for i in range(num_envs)])
        self._t = np.zeros(num_envs, np.int64)
        ones = np.ones(num_envs, np.float32)
        ts = self._upload.upload(self._obs.copy(), np.zeros(num_envs, np.float32),
                                 ones, ones.copy())
        return DMCState(token=torch.zeros((), dtype=torch.int32, device=self.device)), ts

    def host_step(self, actions: np.ndarray):
        act = np.clip(np.asarray(actions, np.float32), -1.0, 1.0)
        nxt = np.tanh(self._obs @ self.a + act @ self.b).astype(np.float32)
        reward = ((1.0 + np.tanh(nxt @ self.w)) * 0.5
                  - 0.1 * (act * act).mean(axis=1)).astype(np.float32)
        self._t += 1
        done = self._t >= self.spec.episode_length
        for i in np.nonzero(done)[0]:
            nxt[i] = self._start(i)
            self._t[i] = 0
        self._obs = nxt
        return (nxt.copy(), reward, np.ones_like(reward), done.astype(np.float32))

    def step(self, state, action, draws):
        from r2d2dpg_torch.envs.dmc_host import fetch_actions

        del draws
        return state, self._upload.upload(*self.host_step(fetch_actions(action)))


def stand_in_factory(seed: int = 0):
    """An ``ExperimentConfig.env_factory`` (``(device) -> env``) of the stand-in."""
    return lambda device: HostStandInEnv(seed, device)


# Every ``torch.distributed`` collective the port calls (``parallel/mesh.py``,
# ``obs/registry.py``).
COLLECTIVES = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
               "reduce_scatter_tensor", "gather", "barrier")


@contextlib.contextmanager
def count_collectives():
    """While the block runs, count the collectives by the calling thread's
    name: yields a ``Counter`` of ``{thread name: calls}``."""
    import torch.distributed as dist

    counts: collections.Counter = collections.Counter()
    lock = threading.Lock()
    saved = {name: getattr(dist, name) for name in COLLECTIVES}

    def counting(fn):
        def call(*args, **kwargs):
            with lock:
                counts[threading.current_thread().name] += 1
            return fn(*args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(dist, name, counting(fn))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)
