"""Port parity: the DM-Control envs (``r2d2dpg_torch/envs/``).

- ``MUJOCO_GL``: the port's default choice equals JAX's
  ``_default_mujoco_gl()``, and importing ``r2d2dpg_torch.envs`` (with the
  configs, the parallel package and the trainers) imports neither mujoco
  nor dm_control: a child process that cannot import them imports the port,
  and building a DM-Control config there raises ``ModuleNotFoundError``.
- ``NativeEnvPool``: the port's own build of ``native/envpool`` against
  the JAX binding's, on the same seeds and actions: obs, reward, discount
  and reset flags bitwise over 50 steps at ``repeat`` 1 and 2, for
  walker-walk, cheetah-run and humanoid-run; the state hooks agree.
- ``DMCHostEnv`` (native and Python pools) against JAX's ``DMCHostEnv``
  with the JAX reset seeds injected (``jax.random.randint`` of the reset
  key): the spec equal, every step bitwise (the action scaling, action
  repeat 2 and 4, across an episode boundary), the pool metrics under
  JAX's names and labels.
- Pixels (64x64x3 uint8 through EGL) stay ``slow``, as JAX's
  ``test_dmc_host_env_pixels`` is.

Exact equality throughout: both packages step the same C++ source and the
same dm_control, with the same float32 inputs.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from r2d2dpg_tpu.envs import dmc_host as jdmc
from r2d2dpg_tpu.envs import native_pool as jnative
from r2d2dpg_torch.envs import dmc_host, native_pool
from r2d2dpg_torch.training import ReplayDraws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASKS = [("walker", "walk"), ("cheetah", "run"), ("humanoid", "run")]


def _eq(got, want, what=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=what)


# ------------------------------------------------------------- MUJOCO_GL
def test_mujoco_gl_choice_equals_jax():
    import r2d2dpg_torch.envs as port_envs
    import r2d2dpg_tpu.envs as jax_envs

    assert port_envs._default_mujoco_gl() == jax_envs._default_mujoco_gl()
    assert os.environ["MUJOCO_GL"]


HIDDEN = """
import importlib.abc, sys
class Hide(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("mujoco", "dm_control"):
            raise ModuleNotFoundError(f"No module named {name!r}", name=name)
        return None
sys.meta_path.insert(0, Hide())
sys.path.insert(0, sys.argv[1])
import os
os.environ.pop("MUJOCO_GL", None)
import r2d2dpg_torch.envs, r2d2dpg_torch.configs, r2d2dpg_torch.parallel
import r2d2dpg_torch.training.pipeline, r2d2dpg_torch.train, r2d2dpg_torch.testing
from r2d2dpg_torch.envs import DMCHostEnv
assert os.environ["MUJOCO_GL"] in ("egl", "glfw", "disabled")
assert not [m for m in sys.modules if m.split(".")[0] in ("mujoco", "dm_control")]
from r2d2dpg_torch.configs import WALKER_R2D2
try:
    WALKER_R2D2.build("cpu")
except ModuleNotFoundError as e:
    print("REFUSED", e.name)
"""


def test_envs_import_without_mujoco_or_dm_control():
    out = subprocess.run([sys.executable, "-c", HIDDEN, REPO], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-2:] == ["REFUSED", "dm_control"]


# ------------------------------------------------------------ native pool
@pytest.fixture(scope="module")
def built():
    """The port's library (its own hash-named file under build/envpool/)."""
    path = native_pool.build()
    assert path.parent == native_pool.BUILD_DIR and path.name.startswith("libenvpool-")
    assert path != __import__("pathlib").Path(jnative._LIB_PATH)
    return path


@pytest.mark.parametrize("repeat", [1, 2])
@pytest.mark.parametrize("domain,task", TASKS)
def test_native_pool_bitwise_jax(built, domain, task, repeat):
    seeds = np.array([3, 11, 2024], np.int64)
    port, ref = native_pool.NativeEnvPool(domain, task), jnative.NativeEnvPool(domain, task)
    for got, want in zip(port.reset_all(seeds), ref.reset_all(seeds)):
        _eq(got, want, "reset_all")
    assert (port.obs_dim, port.action_dim, port.episode_len) == (
        ref.obs_dim, ref.action_dim, ref.episode_len)
    rng = np.random.default_rng(repeat)
    for step in range(50):
        act = rng.uniform(-1, 1, (len(seeds), port.action_dim)).astype(np.float32)
        for name, got, want in zip(("obs", "reward", "discount", "reset"),
                                   port.step_all(act, repeat), ref.step_all(act, repeat)):
            _eq(got, want, f"{domain}-{task} step {step} {name}")
    qpos, qvel = port.get_state(1)
    jq, jv = ref.get_state(1)
    _eq(qpos, jq), _eq(qvel, jv)
    assert port.reward_of(2) == ref.reward_of(2)
    _eq(port.obs_of(0), ref.obs_of(0))
    # The state hooks move both pools alike.
    port.set_state(0, jq, jv)
    ref.set_state(0, jq, jv)
    _eq(port.obs_of(0), ref.obs_of(0))
    port.close(), ref.close()


def test_native_pool_metrics_keep_jax_names(built):
    from r2d2dpg_torch.obs import get_registry

    pool = native_pool.NativeEnvPool("walker", "walk")
    pool.set_role("eval")
    pool.reset_all(np.array([0, 1], np.int64))
    pool.step_all(np.zeros((2, pool.action_dim), np.float32))
    snap = get_registry().snapshot()
    for name in ("r2d2dpg_envpool_step_seconds", "r2d2dpg_envpool_lock_wait_seconds",
                 "r2d2dpg_envpool_resets_total"):
        labels = [s["labels"] for s in snap[name]["samples"]]
        assert any(lab.get("pool") == "native" and lab.get("role") == "eval"
                   for lab in labels), (name, labels)
    with pytest.raises(ValueError, match="repeat must be >= 1"):
        pool.step_all(np.zeros((2, pool.action_dim), np.float32), repeat=0)
    with pytest.raises(ValueError, match="no native task"):
        native_pool.NativeEnvPool("walker", "flip")
    assert not native_pool.is_supported("cheetah", "run", True)
    assert native_pool.NATIVE_TASKS == jnative.NATIVE_TASKS


# ------------------------------------------------------------ DMCHostEnv
def _jax_seeds(key, n):
    return np.asarray(jax.random.randint(key, (n,), 0, 2**31 - 1))


@pytest.mark.parametrize("native,domain,repeat,steps", [
    (True, "walker", 2, 505),    # 500 agent steps an episode: one boundary
    (False, "walker", 4, 255),   # 250 agent steps an episode
    (True, "humanoid", 2, 20),
    (False, "cheetah", 4, 20),
])
def test_dmc_host_env_bitwise_jax(native, domain, repeat, steps):
    task = {"walker": "walk", "humanoid": "run", "cheetah": "run"}[domain]
    n = 2
    ref = jdmc.DMCHostEnv(domain, task, native=native, action_repeat=repeat)
    env = dmc_host.DMCHostEnv(domain, task, native=native, action_repeat=repeat,
                              device="cpu")
    assert env.native == ref.native == native
    assert env.spec.__dict__ == {**ref.spec.__dict__}
    _eq(env._act_min, ref._act_min), _eq(env._act_max, ref._act_max)
    key = jax.random.PRNGKey(7)
    jstate, jts = ref.reset(key, n)
    draws = ReplayDraws([torch.tensor(_jax_seeds(key, n), dtype=torch.int64)])
    state, ts = env.reset(n, draws)
    assert draws.remaining() == 0
    for name in ("obs", "reward", "discount", "reset"):
        _eq(getattr(ts, name).numpy(), getattr(jts, name), f"reset {name}")
    rng = np.random.default_rng(0)
    resets = 0
    for step in range(steps):
        # Beyond the bounds too: both clip, then scale to the spec's range.
        act = rng.uniform(-1.3, 1.3, (n, env.spec.action_dim)).astype(np.float32)
        jstate, jts = ref.step(jstate, jax.numpy.asarray(act), None)
        state, ts = env.step(state, torch.from_numpy(act), None)
        for name in ("obs", "reward", "discount", "reset"):
            _eq(getattr(ts, name).numpy(), getattr(jts, name), f"step {step} {name}")
        resets += int(ts.reset.sum())
    if steps > env.spec.episode_length:
        assert resets == n  # every env crossed its boundary once
    # host_step is the numpy twin of step.
    act = rng.uniform(-1, 1, (n, env.spec.action_dim)).astype(np.float32)
    for got, want in zip(env.host_step(act), ref.host_step(act)):
        _eq(got, want, "host_step")


def test_dmc_host_env_roles_and_refusals():
    env = dmc_host.DMCHostEnv("walker", "walk", device="cpu")
    env.set_role("actor")
    assert env._pool._role == "actor"
    with pytest.raises(ValueError, match="native pool does not support cheetah-run"):
        dmc_host.DMCHostEnv("cheetah", "run", native=True, pixels=True, device="cpu")
    with pytest.raises(ValueError, match="action_repeat must be >= 1"):
        dmc_host.DMCHostEnv("walker", "walk", action_repeat=0, device="cpu")
    # The Evaluator labels its env's pool metrics "eval", as JAX's does.
    from r2d2dpg_torch.training.evaluator import Evaluator

    Evaluator(env, None, num_envs=1)
    assert env._pool._role == "eval"


@pytest.mark.slow
def test_dmc_host_env_pixels_bitwise_jax():
    """64x64x3 uint8 frames on the Python pool (EGL): as JAX's pixels test,
    slow-marked (this box's EGL ends with EGL_BAD_DISPLAY)."""
    ref = jdmc.DMCHostEnv("cheetah", "run", pixels=True, action_repeat=4)
    env = dmc_host.DMCHostEnv("cheetah", "run", pixels=True, action_repeat=4,
                              device="cpu")
    assert env.spec.__dict__ == ref.spec.__dict__ and not env.native
    key = jax.random.PRNGKey(1)
    jstate, jts = ref.reset(key, 2)
    state, ts = env.reset(2, ReplayDraws([torch.tensor(_jax_seeds(key, 2))]))
    assert ts.obs.dtype == torch.uint8 and tuple(ts.obs.shape) == (2, 64, 64, 3)
    _eq(ts.obs.numpy(), jts.obs)
    act = np.zeros((2, env.spec.action_dim), np.float32)
    jstate, jts = ref.step(jstate, jax.numpy.asarray(act), None)
    state, ts = env.step(state, torch.from_numpy(act), None)
    _eq(ts.obs.numpy(), jts.obs)
