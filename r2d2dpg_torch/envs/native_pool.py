"""ctypes binding of the native C++ MuJoCo env pool (``native/envpool``).

Port of ``r2d2dpg_tpu/envs/native_pool.py``.  The C++ pool steps E
``mjData`` instances over one shared ``mjModel`` on a pool of worker
threads, with the suite tasks' observation, reward and reset logic in C++,
so one batched env step is one ctypes call.  ``DMCHostEnv`` uses it for
state observations; pixels and tasks outside ``NATIVE_TASKS`` use the
Python dm_control pool.

The C++ source is shared with the JAX package and is not edited here.  The
port builds its own copy of the library, with the flags of
``native/Makefile``, into ``build/envpool/`` beside the package, named by a
hash of the source, the flags and the mujoco install it links, and moved
into place by one atomic rename.  So a test process of either package and
this one never write the same file, and a concurrent build of the same
hash leaves a whole library or none.  Nothing is built, and neither mujoco
nor dm_control is imported, before the first pool is made.

The pool's metrics keep the JAX names (``r2d2dpg_envpool_step_seconds``,
``r2d2dpg_envpool_lock_wait_seconds``, ``r2d2dpg_envpool_resets_total``),
labelled ``pool="native"|"python"`` and by role.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from r2d2dpg_torch.obs import get_registry


def _pool_instruments(pool: str, role: str = "train"):
    """The env-pool instruments bound to one label set: ``pool`` names the
    implementation (``native`` | ``python``), ``role`` the instance's
    purpose (``train`` | ``eval`` | ``actor``), so concurrent pools never
    share a cell."""
    reg = get_registry()
    step = reg.histogram(
        "r2d2dpg_envpool_step_seconds",
        "whole-fleet batched env step latency",
        labelnames=("pool", "role"),
    ).labels(pool=pool, role=role)
    lock = reg.histogram(
        "r2d2dpg_envpool_lock_wait_seconds",
        "wait to acquire the fleet step lock (cross-thread contention)",
        labelnames=("pool", "role"),
    ).labels(pool=pool, role=role)
    resets = reg.counter(
        "r2d2dpg_envpool_resets_total",
        "episode auto-resets across the fleet",
        labelnames=("pool", "role"),
    ).labels(pool=pool, role=role)
    return step, lock, resets


class PoolObsMixin:
    """Role-labelled pool instruments, bound lazily on the first step (the
    role is set after the factory builds the pool, and an eager bind would
    register an empty ``role="train"`` cell that every scrape carries)."""

    _POOL_KIND = "python"  # "native" | "python"

    def _init_pool_obs(self) -> None:
        self._role = "train"
        self._obs_step = self._obs_lock_wait = self._obs_resets = None

    def set_role(self, role: str) -> None:
        """Name this pool's metric role (``train`` | ``eval`` | ``actor``),
        rebinding in place if it already stepped under another."""
        self._role = role
        if self._obs_step is not None:
            self._bind_pool_obs()

    def _bind_pool_obs(self) -> None:
        self._obs_step, self._obs_lock_wait, self._obs_resets = (
            _pool_instruments(self._POOL_KIND, self._role)
        )


# (domain, task) -> TaskId in native/envpool/env_pool.cc.
NATIVE_TASKS = {
    ("walker", "stand"): 0,
    ("walker", "walk"): 1,
    ("walker", "run"): 2,
    ("cheetah", "run"): 3,
    ("humanoid", "stand"): 4,
    ("humanoid", "walk"): 5,
    ("humanoid", "run"): 6,
}

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _REPO_ROOT / "native" / "envpool" / "env_pool.cc"
BUILD_DIR = _REPO_ROOT / "build" / "envpool"
# native/Makefile's CXXFLAGS and LDFLAGS, less the mujoco paths.
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra")
LD_FLAGS = ("-shared", "-lpthread")

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _suite_xml(domain: str) -> str:
    import dm_control.suite as suite_pkg
    from dm_control.suite import common  # noqa: F401  (locates the suite dir)

    return os.path.join(os.path.dirname(suite_pkg.__file__), f"{domain}.xml")


def _mujoco_install() -> Tuple[str, str]:
    """The mujoco wheel's directory and its ``libmujoco.so*`` file name."""
    import mujoco

    mjdir = os.path.dirname(mujoco.__file__)
    libs = sorted(glob.glob(os.path.join(mjdir, "libmujoco.so*")))
    if not libs:
        raise RuntimeError(f"no libmujoco.so* in {mjdir}")
    return mjdir, os.path.basename(libs[0])


def library_path() -> Path:
    """Where this source, these flags and this mujoco build the library."""
    mjdir, mjlib = _mujoco_install()
    digest = hashlib.sha256(
        SOURCE.read_bytes()
        + " ".join(CXX_FLAGS + LD_FLAGS + (mjdir, mjlib)).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libenvpool-{digest}.so"


def build() -> Path:
    """Compile the pool with ``g++`` unless this hash is built already."""
    out = library_path()
    if out.exists():
        return out
    mjdir, mjlib = _mujoco_install()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [
        os.environ.get("CXX", "g++"), *CXX_FLAGS, f"-I{mjdir}/include",
        str(SOURCE), "-o", str(tmp), *LD_FLAGS[:1], f"-L{mjdir}",
        f"-l:{mjlib}", f"-Wl,-rpath,{mjdir}", *LD_FLAGS[1:],
    ]
    result = subprocess.run(cmd, capture_output=True, text=True)
    if result.returncode != 0:
        raise RuntimeError(
            f"native env-pool build failed ({' '.join(cmd)}):\n"
            f"{result.stdout}\n{result.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def load_library() -> ctypes.CDLL:
    """The env-pool library, built first if this source has no build yet."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        c_float_p = ctypes.POINTER(ctypes.c_float)
        c_double_p = ctypes.POINTER(ctypes.c_double)
        c_int64_p = ctypes.POINTER(ctypes.c_int64)
        lib.envpool_create.restype = ctypes.c_void_p
        lib.envpool_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            c_int64_p, ctypes.c_char_p, ctypes.c_int,
        ]
        lib.envpool_destroy.argtypes = [ctypes.c_void_p]
        for name in ("obs_dim", "action_dim", "episode_len", "nq", "nv", "num_threads"):
            fn = getattr(lib, f"envpool_{name}")
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p]
        lib.envpool_seed.argtypes = [ctypes.c_void_p, c_int64_p]
        lib.envpool_reset_all.argtypes = [ctypes.c_void_p] + [c_float_p] * 4
        lib.envpool_step.argtypes = (
            [ctypes.c_void_p, c_float_p, ctypes.c_int] + [c_float_p] * 4
        )
        lib.envpool_get_state.argtypes = [
            ctypes.c_void_p, ctypes.c_int, c_double_p, c_double_p,
        ]
        lib.envpool_set_state.argtypes = [
            ctypes.c_void_p, ctypes.c_int, c_double_p, c_double_p, c_double_p,
        ]
        lib.envpool_reward_of.restype = ctypes.c_double
        lib.envpool_reward_of.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.envpool_obs_of.argtypes = [ctypes.c_void_p, ctypes.c_int, c_float_p]
        _lib = lib
        return lib


def is_supported(domain: str, task: str, pixels: bool) -> bool:
    return not pixels and (domain, task) in NATIVE_TASKS


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _i64ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


class NativeEnvPool(PoolObsMixin):
    """The C++ pool, with the Python pool's batched contract (state obs).

    ``reset_all(seeds)`` and ``step_all(actions, repeat)`` return
    ``(obs, reward, discount, reset)`` float32 arrays; an episode's end
    auto-resets that env and flags its fresh obs ``reset=1``.
    """

    _POOL_KIND = "native"

    def __init__(self, domain: str, task: str, num_threads: int = 0):
        if (domain, task) not in NATIVE_TASKS:
            raise ValueError(f"no native task for {domain}-{task}")
        self.domain, self.task = domain, task
        self._task_id = NATIVE_TASKS[(domain, task)]
        self._num_threads = num_threads
        self._lib = load_library()
        self._handle: Optional[int] = None
        self._num_envs = 0
        # The C++ pool mutates its E mjData in place, and a collector thread
        # may step it: whole-fleet transitions are serialized.
        self._step_lock = threading.Lock()
        self._init_pool_obs()

    # ------------------------------------------------------------- lifecycle
    def _create(self, seeds: np.ndarray) -> None:
        self.close()
        err = ctypes.create_string_buffer(512)
        seeds64 = np.ascontiguousarray(seeds, np.int64)
        handle = self._lib.envpool_create(
            _suite_xml(self.domain).encode(), self._task_id, len(seeds64),
            self._num_threads, _i64ptr(seeds64), err, len(err),
        )
        if not handle:
            raise RuntimeError(f"envpool_create: {err.value.decode()}")
        self._handle = handle
        self._num_envs = len(seeds64)
        self.obs_dim = self._lib.envpool_obs_dim(handle)
        self.action_dim = self._lib.envpool_action_dim(handle)
        self.episode_len = self._lib.envpool_episode_len(handle)
        # min(max(1, hardware threads), num_envs), or the explicit count.
        self.num_threads = self._lib.envpool_num_threads(handle)

    def close(self) -> None:
        if self._handle:
            self._lib.envpool_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _outputs(self):
        e = self._num_envs
        return (np.empty((e, self.obs_dim), np.float32), np.empty((e,), np.float32),
                np.empty((e,), np.float32), np.empty((e,), np.float32))

    # ------------------------------------------------------------ batch API
    def reset_all(self, seeds: np.ndarray):
        with self._step_lock:
            seeds = np.asarray(seeds)
            if self._handle is None or len(seeds) != self._num_envs:
                self._create(seeds)
            else:
                self._lib.envpool_seed(
                    self._handle, _i64ptr(np.ascontiguousarray(seeds, np.int64)))
            out = self._outputs()
            self._lib.envpool_reset_all(self._handle, *map(_fptr, out))
            return out

    def step_all(self, actions: np.ndarray, repeat: int = 1):
        assert self._handle is not None, "reset_all must run first"
        if repeat < 1:
            raise ValueError(f"repeat must be >= 1, got {repeat}")
        t_lock = time.monotonic()
        if self._obs_step is None:
            self._bind_pool_obs()
        with self._step_lock:
            t0 = time.monotonic()
            self._obs_lock_wait.add(t0 - t_lock)
            actions = np.ascontiguousarray(actions, np.float32)
            assert actions.shape == (self._num_envs, self.action_dim), actions.shape
            out = self._outputs()
            self._lib.envpool_step(
                self._handle, _fptr(actions), int(repeat), *map(_fptr, out))
            self._obs_step.add(time.monotonic() - t0)
            self._obs_resets.inc(float(out[3].sum()))
            return out

    # ---------------------------------------------------------- test hooks
    def get_state(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        qpos = np.empty((self._lib.envpool_nq(self._handle),), np.float64)
        qvel = np.empty((self._lib.envpool_nv(self._handle),), np.float64)
        self._lib.envpool_get_state(self._handle, i, _dptr(qpos), _dptr(qvel))
        return qpos, qvel

    def set_state(self, i: int, qpos, qvel, qacc_warmstart=None) -> None:
        qpos = np.ascontiguousarray(qpos, np.float64)
        qvel = np.ascontiguousarray(qvel, np.float64)
        ws = (
            _dptr(np.ascontiguousarray(qacc_warmstart, np.float64))
            if qacc_warmstart is not None
            else ctypes.POINTER(ctypes.c_double)()
        )
        self._lib.envpool_set_state(self._handle, i, _dptr(qpos), _dptr(qvel), ws)

    def reward_of(self, i: int) -> float:
        return float(self._lib.envpool_reward_of(self._handle, i))

    def obs_of(self, i: int) -> np.ndarray:
        obs = np.empty((self.obs_dim,), np.float32)
        self._lib.envpool_obs_of(self._handle, i, _fptr(obs))
        return obs
