"""Port parity: the learner step against r2d2dpg_tpu.agents.R2D2DPG.

A JAX ``TrainState`` (pendulum_tiny-sized nets: hidden 32) is converted to
the port's; one fixed batch made from a seed, with mid-sequence resets,
stored carries and non-uniform IS weights, goes through one learner step
and a chain of three on both sides.  Compared: all four param sets, both
Adam states, the priorities and every metric.

Tolerance: params and Adam moments atol 1e-5, rtol 1e-4; priorities and
metrics rtol 1e-4, atol 1e-5.  The two sides sum float32 matmuls in other
orders (torch vs XLA:CPU, and autograd vs jax.grad), so gradients agree to
~1e-6 relative.  Adam's first step divides each gradient by its own
magnitude (``m / (sqrt(v) + eps)`` is ~sign(g)), which would amplify that
error only for gradients within a few ulps of 1e-8; none are here, so the
same tolerance holds from the first step on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2dpg_tpu.agents import AgentConfig as JConfig
from r2d2dpg_tpu.agents import R2D2DPG as JAgent
from r2d2dpg_tpu.models import ActorNet as JActor
from r2d2dpg_tpu.models import CriticNet as JCritic
from r2d2dpg_tpu.replay.arena import SequenceBatch as JBatch
from r2d2dpg_torch.agents import AgentConfig, R2D2DPG
from r2d2dpg_torch.convert import (
    net_params_from_flax,
    sequence_batch_from_jax,
    train_state_from_jax,
)
from r2d2dpg_torch.models import ActorNet, CriticNet

B, OBS, ACT, HID = 8, 3, 1, 32
PARAM_TOL = dict(atol=1e-5, rtol=1e-4)
METRIC_TOL = dict(atol=1e-5, rtol=1e-4)


def _agents(use_lstm=True, **kw):
    cfg = dict(burnin=2 if use_lstm else 0, unroll=4, n_step=2, **kw)
    jagent = JAgent(
        JActor(action_dim=ACT, hidden=HID, use_lstm=use_lstm),
        JCritic(hidden=HID, use_lstm=use_lstm),
        JConfig(**cfg),
    )
    tagent = R2D2DPG(
        ActorNet(OBS, ACT, hidden=HID, use_lstm=use_lstm),
        CriticNet(OBS, ACT, hidden=HID, use_lstm=use_lstm),
        AgentConfig(**cfg),
    )
    return jagent, tagent


def _batch(agent, seed=0):
    rng = np.random.default_rng(seed)
    L = agent.config.seq_len
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    reset = (rng.random((B, L)) < 0.15).astype(np.float32)
    carries = {
        "actor": (jnp.asarray(0.5 * f(B, HID)), jnp.asarray(0.5 * f(B, HID))),
        "critic": (jnp.asarray(0.5 * f(B, HID)), jnp.asarray(0.5 * f(B, HID))),
    } if agent.actor.use_lstm else {"actor": (), "critic": ()}
    return JBatch(
        obs=jnp.asarray(f(B, L, OBS)),
        action=jnp.asarray(rng.uniform(-1, 1, (B, L, ACT)).astype(np.float32)),
        reward=jnp.asarray(f(B, L)),
        discount=jnp.asarray(
            (rng.random((B, L)) > 0.05).astype(np.float32)
        ),
        reset=jnp.asarray(reset),
        carries=carries,
    )


def _params_close(t_params, j_params, tol=PARAM_TOL):
    want = net_params_from_flax(jax.device_get(j_params))
    assert set(t_params) == set(want)
    for k in want:
        np.testing.assert_allclose(t_params[k].numpy(), want[k].numpy(), **tol,
                                   err_msg=k)


def _state_close(t, j):
    _params_close(t.actor_params, j.actor_params)
    _params_close(t.critic_params, j.critic_params)
    _params_close(t.target_actor_params, j.target_actor_params)
    _params_close(t.target_critic_params, j.target_critic_params)
    for t_opt, j_opt in ((t.actor_opt_state, j.actor_opt_state),
                         (t.critic_opt_state, j.critic_opt_state)):
        adam = j_opt[1][0]
        assert t_opt.count == int(adam.count)
        _params_close(t_opt.mu, adam.mu)
        _params_close(t_opt.nu, adam.nu, tol=dict(atol=1e-8, rtol=1e-4))
    assert t.step == int(j.step)


def _setup(use_lstm=True, **kw):
    jagent, tagent = _agents(use_lstm, **kw)
    jbatch = _batch(jagent)
    jstate = jagent.init(jax.random.PRNGKey(3), jbatch.obs[:, 0], jbatch.action[:, 0])
    w = np.random.default_rng(9).uniform(0.2, 1.0, B).astype(np.float32)
    return (
        jagent, tagent, jbatch, sequence_batch_from_jax(jax.device_get(jbatch)),
        jstate, train_state_from_jax(jax.device_get(jstate)), w,
    )


@pytest.mark.parametrize("use_lstm", [True, False])
def test_learner_step_chain_matches_jax(use_lstm):
    jagent, tagent, jbatch, tbatch, jstate, tstate, w = _setup(use_lstm)
    jstep = jax.jit(jagent.learner_step)
    for _ in range(3):
        jstate, jprio, jm = jstep(jstate, jbatch, jnp.asarray(w))
        tstate, tprio, tm = tagent.learner_step(tstate, tbatch, torch.from_numpy(w))
        _state_close(tstate, jstate)
        np.testing.assert_allclose(tprio.numpy(), np.asarray(jprio), **METRIC_TOL)
        jm = jax.device_get(jm)
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **METRIC_TOL,
                                       err_msg=k)


def test_fused_and_unfused_burn_in_agree():
    _, tagent, _, tbatch, _, tstate, _ = _setup()
    fused = tagent._burn_in(tstate, tbatch)
    tagent.config = AgentConfig(burnin=2, unroll=4, n_step=2, fused_burnin=False)
    unfused = tagent._burn_in(tstate, tbatch)
    for a, b in zip(fused, unfused):
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, atol=1e-6, rtol=1e-5)


def test_initial_priority_matches_jax():
    jagent, tagent, jbatch, tbatch, jstate, tstate, _ = _setup()
    want = jax.jit(jagent.initial_priority)(jstate, jbatch)
    got = tagent.initial_priority(tstate, tbatch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **METRIC_TOL)


def test_grad_clip_scales_only_at_or_above_the_norm():
    from r2d2dpg_torch.agents.ddpg import clip_by_global_norm

    g = {"a": torch.tensor([3.0, 4.0])}  # norm 5
    torch.testing.assert_close(clip_by_global_norm(g, 5.1)["a"], g["a"])
    torch.testing.assert_close(
        clip_by_global_norm(g, 2.5)["a"], torch.tensor([1.5, 2.0])
    )
    # at exactly the norm optax divides (no +1e-6, unlike clip_grad_norm_)
    torch.testing.assert_close(clip_by_global_norm(g, 5.0)["a"], g["a"])

