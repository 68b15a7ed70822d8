"""Port parity: one pendulum_tiny train phase against the JAX Trainer.

The JAX trainer runs its warm-up and replay-fill phases; its state is then
converted to the port's, with a ``ReplayDraws`` holding exactly the random
numbers the JAX train phase consumes.  Those are re-derived from
``state.rng`` with the same ``jax.random`` split sequence as
``Trainer._collect`` / ``_learn`` / ``_learn_many`` (trainer.py:332-339,
501-508) and ``Pendulum._init_state``.  Both sides then run one train
phase.  Compared: the env state and window (atol 1e-5 — the collect runs
the nets), the arena priorities and the params (atol 1e-5, rtol 1e-4, as in
test_torch_agent.py), and every metric (rtol 1e-4, atol 1e-5).

Also: the Pendulum dynamics alone, and the training CLI on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2dpg_tpu.configs import PENDULUM_TINY as J_TINY
from r2d2dpg_tpu.envs.pendulum import Pendulum as JPendulum
from r2d2dpg_tpu.envs.pendulum import PendulumState as JPendulumState
from r2d2dpg_torch.configs import PENDULUM_TINY
from r2d2dpg_torch.convert import net_params_from_flax, trainer_state_from_jax
from r2d2dpg_torch.envs import Pendulum, PendulumState
from r2d2dpg_torch.training import ReplayDraws

TOL = dict(atol=1e-5, rtol=1e-4)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.tensor(np.asarray(x))


def _train_phase_draws(rng, tcfg, action_dim, smoothing_shape=None):
    """The draws of one JAX train phase, in the order the port consumes them.

    ``smoothing_shape`` (``(U + n, B, A)``): target-policy smoothing is on,
    and each learner step also draws its normal from ``fold_in(key, 1)``
    (``Trainer._update_step``).
    """
    E = tcfg.num_envs
    draws = []
    rng, scan_key = jax.random.split(rng)  # Trainer._collect
    for key in jax.random.split(scan_key, tcfg.stride):
        k_noise, k_env = jax.random.split(key)
        draws.append(jax.random.normal(k_noise, (E, action_dim), jnp.float32))
        k12 = jax.vmap(jax.random.split)(jax.random.split(k_env, E))  # [E, 2]
        draws.append(jax.vmap(
            lambda k: jax.random.uniform(k, (), minval=-jnp.pi, maxval=jnp.pi)
        )(k12[:, 0]))
        draws.append(jax.vmap(
            lambda k: jax.random.uniform(k, (), minval=-1.0, maxval=1.0)
        )(k12[:, 1]))
    _, key = jax.random.split(rng)  # Trainer._learn
    for k in jax.random.split(key, tcfg.learner_steps):  # _learn_many
        draws.append(jax.random.uniform(k, (tcfg.batch_size,)))
        if smoothing_shape is not None:
            draws.append(jax.random.normal(jax.random.fold_in(k, 1), smoothing_shape))
    return [_t(x) for x in draws]


@pytest.fixture(scope="module")
def after_one_train_phase():
    jt = J_TINY.build()
    js = jt.init()
    for _ in range(jt.window_fill_phases):
        js = jt.collect_phase(js)
    for _ in range(jt.replay_fill_phases):
        js = jt.fill_phase(js)
    host = jax.device_get(js)  # before train_phase donates the state
    draws = ReplayDraws(
        _train_phase_draws(js.rng, jt.config, jt.env.spec.action_dim)
    )
    tt = PENDULUM_TINY.build("cpu")
    ts = trainer_state_from_jax(host, draws, device="cpu")
    js, jm = jt.train_phase(js)
    ts, tm = tt.train_phase(ts)
    return jax.device_get(js), jax.device_get(jm), ts, tm, draws


def test_train_phase_consumes_exactly_the_jax_draws(after_one_train_phase):
    *_, draws = after_one_train_phase
    assert draws.remaining() == 0


def test_train_phase_env_window_and_counters_match(after_one_train_phase):
    js, _, ts, _, _ = after_one_train_phase
    np.testing.assert_allclose(ts.env_state.theta.numpy(), js.env_state.theta, **TOL)
    np.testing.assert_allclose(ts.env_state.thdot.numpy(), js.env_state.thdot, **TOL)
    np.testing.assert_array_equal(ts.env_state.t.numpy(), js.env_state.t)
    np.testing.assert_allclose(ts.obs.numpy(), js.obs, **TOL)
    for name in ("obs", "action", "reward", "discount", "reset"):
        np.testing.assert_allclose(
            getattr(ts.window, name).numpy(), getattr(js.window, name), **TOL,
            err_msg=name,
        )
    for net in ("actor", "critic"):
        for x, y in zip(ts.window.carries[net], js.window.carries[net], strict=True):
            np.testing.assert_allclose(x.numpy(), y, **TOL)
    assert ts.phase_idx == int(js.phase_idx)
    assert ts.env_steps == int(js.env_steps)
    np.testing.assert_allclose(ts.episode_return.numpy(), js.episode_return, **TOL)


def test_train_phase_arena_and_params_match(after_one_train_phase):
    js, _, ts, _, _ = after_one_train_phase
    np.testing.assert_allclose(ts.arena.priority.numpy(), js.arena.priority, **TOL)
    np.testing.assert_array_equal(ts.arena.meta.numpy(), js.arena.meta)
    assert ts.arena.cursor == int(js.arena.cursor)
    assert ts.train.step == int(js.train.step)
    for name in ("actor_params", "critic_params",
                 "target_actor_params", "target_critic_params"):
        want = net_params_from_flax(getattr(js.train, name))
        got = getattr(ts.train, name)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **TOL,
                                       err_msg=f"{name}.{k}")


def test_train_phase_metrics_match(after_one_train_phase):
    _, jm, _, tm, _ = after_one_train_phase
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL, err_msg=k)


def test_pendulum_step_matches_jax_including_auto_reset():
    rng = np.random.default_rng(0)
    E = 6
    theta = rng.uniform(-4, 4, E).astype(np.float32)
    thdot = rng.uniform(-8, 8, E).astype(np.float32)
    t = np.array([0, 5, 198, 199, 199, 100], np.int32)
    action = rng.uniform(-1.5, 1.5, (E, 1)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    keys = jax.random.split(key, E)
    jenv = JPendulum()
    jstate, jts = jax.vmap(jenv.step)(
        JPendulumState(jnp.asarray(theta), jnp.asarray(thdot), jnp.asarray(t)),
        jnp.asarray(action), keys,
    )
    fresh = jax.vmap(jenv._init_state)(keys)
    env = Pendulum(device="cpu")
    tstate, tts = env.step(
        PendulumState(_t(theta), _t(thdot), _t(t)), _t(action),
        ReplayDraws([_t(fresh.theta), _t(fresh.thdot)]),
    )
    for got, want in ((tstate.theta, jstate.theta), (tstate.thdot, jstate.thdot),
                      (tts.obs, jts.obs), (tts.reward, jts.reward),
                      (tts.discount, jts.discount), (tts.reset, jts.reset)):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tstate.t.numpy(), _np(jstate.t))
    assert tts.reset.tolist() == [0, 0, 0, 1, 1, 0]


def test_train_cli_runs_on_cpu(capsys):
    from r2d2dpg_torch.train import main

    state = main([
        "--config", "pendulum_tiny", "--phases", "3", "--log-every", "2",
        "--seed", "1", "--device", "cpu",
    ])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "backend: cpu"
    # warm 2 + fill 2 + 3 train phases, a log line every 2 phases
    assert [line.split()[1] for line in out[1:]] == ["2/7", "4/7", "6/7"]
    assert "critic_loss" in out[-1] and "quality_replay_age" in out[-1]
    assert state.train.step == 3
    assert state.arena.total_added == 4 * 5


def test_param_sync_snapshot_refreshes_every_k_phases():
    cfg = dataclasses.replace(
        PENDULUM_TINY,
        trainer=dataclasses.replace(PENDULUM_TINY.trainer, param_sync_every=3),
    )
    trainer = cfg.build("cpu")
    fill = trainer.window_fill_phases + trainer.replay_fill_phases
    state = trainer.run(fill, log_every=0)
    state, _ = trainer.train_phase(state)  # phase_idx 4 -> no refresh at 4
    stale = state.behavior_params
    state, _ = trainer.train_phase(state)  # phase 5: still stale
    assert state.behavior_params is stale
    state, _ = trainer.train_phase(state)  # phase 6: refresh from learner
    assert state.behavior_params is not stale
    assert any(not torch.equal(state.behavior_params[k], v) for k, v in stale.items())


@pytest.mark.parametrize("noise,initial_priority", [("ou", "max"), ("none", "td")])
def test_trainer_options_run(noise, initial_priority):
    cfg = dataclasses.replace(
        PENDULUM_TINY,
        trainer=dataclasses.replace(
            PENDULUM_TINY.trainer, noise=noise, initial_priority=initial_priority
        ),
    )
    trainer = cfg.build("cpu")
    fill = trainer.window_fill_phases + trainer.replay_fill_phases
    state = trainer.run(fill + 2, log_every=0)
    assert state.train.step == 2
    assert torch.isfinite(state.arena.priority).all()
