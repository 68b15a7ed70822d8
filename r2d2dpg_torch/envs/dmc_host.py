"""DM-Control environments stepped on the host, batched over a pool.

Port of ``r2d2dpg_tpu/envs/dmc_host.py``.  MuJoCo physics runs on the host:
a pool of E envs (the native C++ pool for state observations, or E
dm_control envs on a thread pool) steps the whole fleet in one call.  The
JAX package reaches it from inside its jitted collect through an ordered
``io_callback``; the port's collect is a Python loop, so ``step`` calls the
pool directly, in program order.

One step is one host round trip: the ``[E, A]`` actions come to the host
(a blocking copy, since the physics needs them), are scaled to the action
bounds and stepped, and the step's obs, reward, discount and reset flags go
back to the env's device as one packed copy through a pinned staging ring
(``envs/core.py::HostUpload``).

Contract, as in JAX:

- ``batched = True``: ``reset(num_envs, draws)`` and ``step(state,
  actions, draws)`` work on ``[E, ...]`` tensors.  The reset's per-env
  seeds are integer draws in ``[0, 2**31 - 1)`` (``draws.randint``); a step
  draws nothing, since the host envs own their randomness.
- Auto-reset: at an episode's end the pool resets that env and returns the
  fresh obs with ``reset=1``; ``discount`` keeps dm_control's meaning (0
  only on termination, 1 on a time-limit truncation).
- ``action_repeat``: each action is applied for that many control steps,
  rewards summed, stopping at an episode boundary; the agent-visible
  horizon is ``ceil(limit / action_repeat)``.
- Pixels: 64x64x3 uint8 frames rendered through MuJoCo's EGL backend, on
  the Python pool only; each env is pinned to one render thread (an EGL
  context is current on one thread at a time).

``host_step`` is the numpy step a host-driven trainer calls between its
device dispatches (``parallel/hybrid.py``).  mujoco and dm_control are
imported when an env is built, never when this module is imported.
"""

from __future__ import annotations

import atexit
import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch

from r2d2dpg_torch.device import resolve_device
from r2d2dpg_torch.envs.core import EnvSpec, HostUpload, TimeStep
from r2d2dpg_torch.envs.native_pool import PoolObsMixin

_PIXEL_HW = 64
SEED_HIGH = 2**31 - 1  # reset seeds are integer draws in [0, SEED_HIGH)


def _load_dmc(domain: str, task: str, seed: int):
    from dm_control import suite

    return suite.load(domain, task, task_kwargs={"random": seed})


def _flatten_obs(obs_dict) -> np.ndarray:
    parts = [np.asarray(v, np.float32).reshape(-1) for v in obs_dict.values()]
    return np.concatenate(parts) if parts else np.zeros((0,), np.float32)


class _HostPool(PoolObsMixin):
    """The Python fleet: E dm_control envs and a thread pool."""

    # Render threads; env i renders on thread i mod K (an EGL context must
    # not migrate between threads), K renders at once.
    RENDER_THREADS = 8

    def __init__(self, domain: str, task: str, pixels: bool, camera_id: int):
        self.domain, self.task = domain, task
        self.pixels = pixels
        self.camera_id = camera_id
        self.envs: list = []
        self.executor: Optional[ThreadPoolExecutor] = None
        self.render_threads: list = []
        self._atexit_registered = False
        # Host env state is mutable and a collector thread may step it:
        # whole-fleet transitions are serialized.
        self._step_lock = threading.Lock()
        self._init_pool_obs()

    def ensure(self, seeds: np.ndarray):
        """Create or re-seed the fleet to match the per-env ``seeds``."""
        num_envs = len(seeds)
        if len(self.envs) != num_envs:
            if self.envs and self.pixels:
                # Free the outgoing fleet's EGL contexts on their threads
                # before the new fleet replaces them.
                self._free_render_contexts()
                for t in self.render_threads:
                    t.shutdown(wait=False)
            if self.executor is not None:
                self.executor.shutdown(wait=False)
            self.envs = [_load_dmc(self.domain, self.task, int(s)) for s in seeds]
            self.executor = ThreadPoolExecutor(max_workers=min(32, max(1, num_envs)))
            if self.pixels:
                self.render_threads = [
                    ThreadPoolExecutor(max_workers=1)
                    for _ in range(min(self.RENDER_THREADS, num_envs))
                ]
                # Free each EGL context from the thread it is current on;
                # dm_control's own exit hook would fail with EGL_BAD_ACCESS.
                if not self._atexit_registered:
                    atexit.register(self._free_render_contexts)
                    self._atexit_registered = True
        else:
            for env, s in zip(self.envs, seeds):
                env.task._random = np.random.RandomState(int(s))

    def _free_render_contexts(self, total_timeout: float = 10.0):
        def _free(lo):
            for i in range(lo, len(self.envs), len(self.render_threads)):
                try:
                    self.envs[i].physics.free()
                except Exception:
                    pass

        deadline = time.monotonic() + total_timeout
        futs = []
        for k, t in enumerate(self.render_threads):
            try:
                # At exit the executors' threads may be joined already.
                futs.append(t.submit(_free, k))
            except Exception:
                pass
        for f in futs:
            try:
                f.result(timeout=max(0.0, deadline - time.monotonic()))
            except Exception:
                pass

    def _render_all(self) -> np.ndarray:
        futs = [
            self.render_threads[i % len(self.render_threads)].submit(
                env.physics.render, height=_PIXEL_HW, width=_PIXEL_HW,
                camera_id=self.camera_id,
            )
            for i, env in enumerate(self.envs)
        ]
        return np.stack([f.result() for f in futs])

    def _obs_all(self, dm_steps) -> np.ndarray:
        if self.pixels:
            return self._render_all()
        return np.stack([_flatten_obs(ts.observation) for ts in dm_steps])

    def reset_all(self, seeds: np.ndarray):
        with self._step_lock:
            self.ensure(seeds)
            obs = self._obs_all([env.reset() for env in self.envs])
            e = len(self.envs)
            return (obs, np.zeros((e,), np.float32), np.ones((e,), np.float32),
                    np.ones((e,), np.float32))

    def step_all(self, actions: np.ndarray, repeat: int = 1):
        if repeat < 1:
            raise ValueError(f"repeat must be >= 1, got {repeat}")
        t_lock = time.monotonic()
        if self._obs_step is None:
            self._bind_pool_obs()
        with self._step_lock:
            t0 = time.monotonic()
            self._obs_lock_wait.add(t0 - t_lock)
            out = self._step_all_locked(actions, repeat)
            self._obs_step.add(time.monotonic() - t0)
            self._obs_resets.inc(float(out[3].sum()))
            return out

    def _step_all_locked(self, actions: np.ndarray, repeat: int):
        def step_one(i):
            env = self.envs[i]
            # The same control for `repeat` steps, rewards summed, stopping
            # at the episode boundary.
            reward = np.float32(0.0)
            discount = np.float32(1.0)
            for _ in range(repeat):
                dm_ts = env.step(actions[i])
                reward += np.float32(dm_ts.reward or 0.0)
                discount *= np.float32(1.0 if dm_ts.discount is None else dm_ts.discount)
                if dm_ts.last():
                    return env.reset(), reward, discount, np.float32(1.0)
            return dm_ts, reward, discount, np.float32(0.0)

        results = list(self.executor.map(step_one, range(len(self.envs))))
        obs = self._obs_all([r[0] for r in results])
        return (obs, np.stack([r[1] for r in results]),
                np.stack([r[2] for r in results]), np.stack([r[3] for r in results]))


@dataclasses.dataclass(frozen=True)
class DMCState:
    """The device side of a host env's state: the pool owns the real state.
    The token is JAX's dependency chain; eager torch steps the pool in
    program order and carries the token unchanged."""

    token: torch.Tensor


class DMCHostEnv:
    """A batched env over a host dm_control (or native) pool."""

    batched = True

    def __init__(
        self,
        domain: str,
        task: str,
        *,
        pixels: bool = False,
        camera_id: int = 0,
        native: Optional[bool] = None,
        action_repeat: int = 1,
        device=None,
    ):
        """``native``: True forces the C++ pool, False the Python pool, None
        takes the C++ pool where the task supports it (state obs only;
        pixels always render through the Python pool).  ``device``: where
        ``reset``/``step`` put their tensors (``cuda`` by default)."""
        if action_repeat < 1:
            raise ValueError(f"action_repeat must be >= 1, got {action_repeat}")
        self.action_repeat = action_repeat
        self.device = resolve_device(device)
        # MUJOCO_GL is pinned when r2d2dpg_torch.envs is imported.
        probe = _load_dmc(domain, task, 0)
        action_spec = probe.action_spec()
        self._act_min = np.asarray(action_spec.minimum, np.float32)
        self._act_max = np.asarray(action_spec.maximum, np.float32)
        ts0 = probe.reset()
        if pixels:
            obs_shape: Tuple[int, ...] = (_PIXEL_HW, _PIXEL_HW, 3)
        else:
            obs_shape = _flatten_obs(ts0.observation).shape
        limit = getattr(probe, "_step_limit", 1000)
        limit = int(limit) if np.isfinite(limit) else 1000
        self.spec = EnvSpec(
            name=f"{domain}-{task}" + ("-pixels" if pixels else ""),
            obs_shape=obs_shape,
            action_dim=int(np.prod(action_spec.shape)),
            action_min=float(self._act_min.min()),
            action_max=float(self._act_max.max()),
            # The agent-visible horizon: control steps / action_repeat.
            episode_length=-(-limit // action_repeat),
            pixels=pixels,
        )
        probe.close()
        from r2d2dpg_torch.envs import native_pool

        use_native = native_pool.is_supported(domain, task, pixels) if native is None else native
        if use_native:
            if not native_pool.is_supported(domain, task, pixels):
                raise ValueError(
                    f"native pool does not support {domain}-{task}"
                    f"{' (pixels)' if pixels else ''}"
                )
            try:
                self._pool = native_pool.NativeEnvPool(domain, task)
            except Exception:
                if native:  # asked for: surface the build error
                    raise
                # Chosen, not asked for (no compiler, say): the Python pool.
                use_native = False
                self._pool = _HostPool(domain, task, pixels, camera_id)
        else:
            self._pool = _HostPool(domain, task, pixels, camera_id)
        self.native = use_native
        self._upload = HostUpload(self.device)

    def set_role(self, role: str) -> None:
        """Label this env's pool metrics by purpose (train | eval | actor)."""
        self._pool.set_role(role)

    # ------------------------------------------------------------ batched API
    def reset(self, num_envs: int, draws) -> Tuple[DMCState, TimeStep]:
        seeds = draws.randint((num_envs,), 0, SEED_HIGH).cpu().numpy()
        ts = self._upload.upload(*self._pool.reset_all(seeds))
        return DMCState(token=torch.zeros((), dtype=torch.int32, device=self.device)), ts

    def step(self, state: DMCState, actions: torch.Tensor, draws) -> Tuple[DMCState, TimeStep]:
        del draws  # the host envs own their randomness (seeded at reset)
        return state, self._upload.upload(*self.host_step(fetch_actions(actions)))

    # ------------------------------------------------------- host-level API
    def host_step(self, actions: np.ndarray):
        """numpy step: canonical [-1, 1] actions -> (obs, reward, discount, reset)."""
        lo, hi = self._act_min, self._act_max
        scaled = lo + (np.clip(actions, -1.0, 1.0) + 1.0) * 0.5 * (hi - lo)
        return self._pool.step_all(scaled.astype(np.float32), repeat=self.action_repeat)


def fetch_actions(actions: torch.Tensor) -> np.ndarray:
    """``[E, A]`` actions on the host as float32 numpy (the blocking
    device-to-host half of a host step)."""
    return actions.detach().to("cpu", torch.float32).numpy()
