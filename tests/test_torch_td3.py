"""Port parity: the TD3 knobs (twin critic, target-policy smoothing) against JAX.

Modelled on tests/test_td3_knobs.py.  A JAX ``TrainState`` (hidden 32) is
converted to the port's; the smoothing noise is the standard normal JAX
draws from the step's key (``jax.random.normal(key, [U + n, B, A])``),
handed to the port's ``learner_step`` as ``normal``.  In the trainer test
the port's ``ReplayDraws`` holds every draw of the JAX train phase,
the smoothing normal from ``fold_in(key, 1)`` after each step's sampling
uniforms.

Tolerances are those of tests/test_torch_agent.py (params and Adam moments
atol 1e-5, rtol 1e-4; priorities and metrics rtol 1e-4, atol 1e-5) and of
tests/test_torch_trainer.py for the train phase: the knobs add a min, a
clip and a sum over members, none of which changes the float32 error.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2dpg_torch.convert import net_params_from_flax, train_state_from_jax
from test_torch_agent import (
    ACT,
    B,
    METRIC_TOL,
    _agents,
    _setup,
    _state_close,
)

KNOBS = {
    "twin": dict(twin_critic=True),
    "smoothing": dict(target_policy_sigma=0.2),
    "both": dict(twin_critic=True, target_policy_sigma=0.2),
}


def _normal(jagent, key):
    cfg = jagent.config
    shape = (cfg.unroll + cfg.n_step, B, ACT)
    return torch.tensor(np.asarray(jax.random.normal(key, shape)))


@pytest.mark.parametrize("use_lstm", [True, False])
def test_twin_critic_shapes(use_lstm):
    _, twin = _agents(use_lstm, twin_critic=True)
    _, plain = _agents(use_lstm)
    ts = twin.init(torch.Generator().manual_seed(0), "cpu")
    ps = plain.init(torch.Generator().manual_seed(0), "cpu")
    for k, v in ps.critic_params.items():
        assert ts.critic_params[k].shape == (2,) + v.shape, k
        assert ts.critic_opt_state.mu[k].shape == (2,) + v.shape, k
        assert ts.target_critic_params[k].shape == (2,) + v.shape, k
    for k, v in ps.actor_params.items():
        assert ts.actor_params[k].shape == v.shape, k
    # Independent inits (biases start at zero in both members).
    w = ts.critic_params["mix.weight"]
    assert not torch.equal(w[0], w[1])
    # The first member comes from the generator where the plain critic does.
    torch.testing.assert_close(w[0], ps.critic_params["mix.weight"], rtol=0, atol=0)


def test_twin_train_state_converts_member_by_member_and_steps():
    """A JAX twin TrainState converts with each [2, in, out] kernel becoming
    [2, out, in] (no axis reversal) and takes one step that matches JAX."""
    jagent, tagent, jbatch, tbatch, jstate, tstate, w = _setup(twin_critic=True)
    host = jax.device_get(jstate.critic_params)
    for i in range(2):
        member = jax.tree_util.tree_map(lambda x: x[i], host)
        want = net_params_from_flax(member)
        for k, v in want.items():
            torch.testing.assert_close(tstate.critic_params[k][i], v, rtol=0, atol=0)
    state = train_state_from_jax(jax.device_get(jstate))
    jnew, jprio, _ = jax.jit(jagent.learner_step)(jstate, jbatch, jnp.asarray(w))
    tnew, tprio, _ = tagent.learner_step(state, tbatch, torch.from_numpy(w))
    _state_close(tnew, jnew)
    np.testing.assert_allclose(tprio.numpy(), np.asarray(jprio), **METRIC_TOL)


@pytest.mark.parametrize("use_lstm", [True, False])
@pytest.mark.parametrize("knobs", sorted(KNOBS))
def test_learner_step_chain_matches_jax(knobs, use_lstm):
    jagent, tagent, jbatch, tbatch, jstate, tstate, w = _setup(use_lstm, **KNOBS[knobs])
    jstep = jax.jit(jagent.learner_step)
    smoothing = tagent.config.target_policy_sigma > 0
    for key in jax.random.split(jax.random.PRNGKey(21), 3):
        jstate, jprio, jm = jstep(jstate, jbatch, jnp.asarray(w), key)
        tstate, tprio, tm = tagent.learner_step(
            tstate, tbatch, torch.from_numpy(w),
            _normal(jagent, key) if smoothing else None,
        )
        _state_close(tstate, jstate)
        np.testing.assert_allclose(tprio.numpy(), np.asarray(jprio), **METRIC_TOL)
        jm = jax.device_get(jm)
        assert set(tm) == set(jm)
        assert ("q_spread" in tm) == tagent.config.twin_critic
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **METRIC_TOL,
                                       err_msg=k)


def test_twin_fused_and_unfused_burn_in_agree_and_match_jax():
    jagent, tagent, jbatch, tbatch, jstate, tstate, _ = _setup(twin_critic=True)
    fused = tagent._burn_in(tstate, tbatch)
    want = jax.device_get(jagent._burn_in(jstate, jbatch))
    tagent.config = dataclasses.replace(tagent.config, fused_burnin=False)
    unfused = tagent._burn_in(tstate, tbatch)
    for a, b, j in zip(fused, unfused, want):
        for x, y, z in zip(a, b, j):
            torch.testing.assert_close(x, y, atol=1e-6, rtol=1e-5)
            np.testing.assert_allclose(x.numpy(), z, atol=1e-6, rtol=1e-5)
    # critic carries are stacked over the two members
    assert fused[2][0].shape[0] == 2 and fused[3][0].shape[0] == 2


@pytest.mark.parametrize("use_lstm", [True, False])
def test_twin_initial_priority_matches_jax(use_lstm):
    jagent, tagent, jbatch, tbatch, jstate, tstate, _ = _setup(
        use_lstm, twin_critic=True, target_policy_sigma=0.2
    )
    want = jax.jit(jagent.initial_priority)(jstate, jbatch)
    got = tagent.initial_priority(tstate, tbatch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **METRIC_TOL)


def test_q_spread_is_the_mean_member_gap():
    _, tagent, _, tbatch, _, tstate, w = _setup(twin_critic=True)
    _, _, metrics = tagent.learner_step(tstate, tbatch, torch.from_numpy(w))
    ca_on, _, cc_on, _ = tagent._burn_in(tstate, tbatch)
    obs_w, act_w, reset_w = tagent._window(tbatch)
    U = tagent.config.unroll
    q_tm, _ = tagent._unroll_critic(
        tstate.critic_params, cc_on, obs_w[:U], act_w[:U], reset_w[:U]
    )
    want = (q_tm[:, 0] - q_tm[:, 1]).abs().mean()
    torch.testing.assert_close(metrics["q_spread"], want, rtol=1e-6, atol=0)
    assert float(metrics["q_spread"]) > 0


def test_smoothing_requires_and_uses_the_normal():
    jagent, tagent, _, tbatch, _, tstate, w = _setup(target_policy_sigma=0.2)
    with pytest.raises(ValueError, match="target_policy_sigma"):
        tagent.learner_step(tstate, tbatch, torch.from_numpy(w))
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    _, p1, _ = tagent.learner_step(tstate, tbatch, torch.from_numpy(w), _normal(jagent, k1))
    _, p2, _ = tagent.learner_step(tstate, tbatch, torch.from_numpy(w), _normal(jagent, k2))
    assert not torch.allclose(p1, p2)


# ------------------------------------------------------------- the trainer
@pytest.fixture(scope="module")
def td3_train_phase():
    from r2d2dpg_tpu.configs import PENDULUM_TINY as J_TINY
    from r2d2dpg_torch.configs import PENDULUM_TINY
    from r2d2dpg_torch.training import ReplayDraws
    from test_torch_trainer import _train_phase_draws

    knobs = KNOBS["both"]
    jcfg = dataclasses.replace(J_TINY, agent=dataclasses.replace(J_TINY.agent, **knobs))
    tcfg = dataclasses.replace(
        PENDULUM_TINY, agent=dataclasses.replace(PENDULUM_TINY.agent, **knobs)
    )
    jt = jcfg.build()
    js = jt.init()
    for _ in range(jt.window_fill_phases):
        js = jt.collect_phase(js)
    for _ in range(jt.replay_fill_phases):
        js = jt.fill_phase(js)
    host = jax.device_get(js)
    a = jcfg.agent
    smoothing_shape = (a.unroll + a.n_step, jt.config.batch_size, jt.env.spec.action_dim)
    draws = ReplayDraws(_train_phase_draws(
        js.rng, jt.config, jt.env.spec.action_dim, smoothing_shape
    ))
    from r2d2dpg_torch.convert import trainer_state_from_jax

    tt = tcfg.build("cpu")
    ts = trainer_state_from_jax(host, draws, device="cpu")
    js, jm = jt.train_phase(js)
    ts, tm = tt.train_phase(ts)
    return jax.device_get(js), jax.device_get(jm), ts, tm, draws


def test_td3_train_phase_matches_jax(td3_train_phase):
    from test_torch_trainer import TOL

    js, jm, ts, tm, draws = td3_train_phase
    assert draws.remaining() == 0
    # collection advanced the critic carry with member 0
    for x, y in zip(ts.critic_carry, js.critic_carry, strict=True):
        np.testing.assert_allclose(x.numpy(), y, **TOL)
    np.testing.assert_allclose(ts.arena.priority.numpy(), js.arena.priority, **TOL)
    for name in ("actor_params", "critic_params",
                 "target_actor_params", "target_critic_params"):
        want = net_params_from_flax(getattr(js.train, name))
        got = getattr(ts.train, name)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **TOL,
                                       err_msg=f"{name}.{k}")
    assert set(tm) == set(jm) and "q_spread" in tm
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL, err_msg=k)
