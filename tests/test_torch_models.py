"""Port parity: r2d2dpg_torch.models against the flax nets, through convert.py.

The flax nets are initialized by JAX; their params go through
``r2d2dpg_torch.convert`` into the port's nets, and both packages run the
same numpy inputs (made from a seed) for a single step and for a T-step
unroll with mid-sequence resets.  Tolerance: rtol 1e-5, atol 1e-6 — float32
matmuls accumulate in another order in torch than in XLA:CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2dpg_tpu.models import ActorNet as JActor
from r2d2dpg_tpu.models import CriticNet as JCritic
from r2d2dpg_tpu.models import unroll as junroll
from r2d2dpg_torch.convert import carry_from_jax, net_params_from_flax
from r2d2dpg_torch.models import ActorNet, CriticNet, unroll, zeros_where_reset

B, OBS, ACT, HID, T = 5, 3, 2, 32, 9
RTOL, ATOL = 1e-5, 1e-6


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want):
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL
    )


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((T, B, OBS)).astype(np.float32)
    act = rng.uniform(-1, 1, (T, B, ACT)).astype(np.float32)
    reset = (rng.random((T, B)) < 0.25).astype(np.float32)
    reset[0] = 0.0
    c = rng.standard_normal((B, HID)).astype(np.float32)
    h = rng.standard_normal((B, HID)).astype(np.float32)
    return obs, act, reset, (c, h)


def _nets(use_lstm):
    jactor = JActor(action_dim=ACT, hidden=HID, use_lstm=use_lstm)
    jcritic = JCritic(hidden=HID, use_lstm=use_lstm)
    obs0 = jnp.zeros((B, OBS))
    reset0 = jnp.zeros((B,))
    carry0 = jactor.initial_carry(B)
    ka, kc = jax.random.split(jax.random.PRNGKey(7))
    pa = jax.device_get(jactor.init(ka, obs0, carry0, reset0))
    pc = jax.device_get(
        jcritic.init(kc, obs0, jnp.zeros((B, ACT)), carry0, reset0)
    )
    actor = ActorNet(OBS, ACT, hidden=HID, use_lstm=use_lstm)
    critic = CriticNet(OBS, ACT, hidden=HID, use_lstm=use_lstm)
    return (jactor, pa, actor, net_params_from_flax(pa)), (
        jcritic, pc, critic, net_params_from_flax(pc)
    )


@pytest.mark.parametrize("use_lstm", [True, False])
def test_converted_params_fill_the_port_nets_exactly(use_lstm):
    (_, _, actor, ta), (_, _, critic, tc) = _nets(use_lstm)
    for net, params in ((actor, ta), (critic, tc)):
        want = {k: tuple(v.shape) for k, v in net.named_parameters()}
        assert {k: tuple(v.shape) for k, v in params.items()} == want


@pytest.mark.parametrize("use_lstm", [True, False])
def test_single_step_matches_flax(use_lstm):
    (jactor, pa, actor, ta), (jcritic, pc, critic, tc) = _nets(use_lstm)
    obs, act, reset, carry = _inputs()
    jcarry = tuple(jnp.asarray(x) for x in carry) if use_lstm else ()
    tcarry = carry_from_jax(carry) if use_lstm else ()
    reset_t = reset[1]  # some lanes reset

    a_j, ca_j = jactor.apply(pa, jnp.asarray(obs[1]), jcarry, jnp.asarray(reset_t))
    a_t, ca_t = actor.apply_params(ta, _t(obs[1]), tcarry, _t(reset_t))
    _close(a_t, a_j)
    for x, y in zip(ca_t, ca_j):
        _close(x, y)

    q_j, cc_j = jcritic.apply(
        pc, jnp.asarray(obs[1]), jnp.asarray(act[1]), jcarry, jnp.asarray(reset_t)
    )
    q_t, cc_t = critic.apply_params(tc, _t(obs[1]), _t(act[1]), tcarry, _t(reset_t))
    assert q_t.shape == (B,)
    _close(q_t, q_j)
    for x, y in zip(cc_t, cc_j):
        _close(x, y)


@pytest.mark.parametrize("use_lstm", [True, False])
def test_unroll_with_mid_sequence_resets_matches_flax(use_lstm):
    (jactor, pa, actor, ta), (jcritic, pc, critic, tc) = _nets(use_lstm)
    obs, act, reset, carry = _inputs(seed=1)
    jcarry = tuple(jnp.asarray(x) for x in carry) if use_lstm else ()
    tcarry = carry_from_jax(carry) if use_lstm else ()

    a_j, ca_j = junroll(
        lambda c, o, r: jactor.apply(pa, o, c, r), jcarry,
        jnp.asarray(obs), jnp.asarray(reset),
    )
    a_t, ca_t = unroll(
        lambda c, o, r: actor.apply_params(ta, o, c, r), tcarry, _t(obs), _t(reset)
    )
    _close(a_t, a_j)
    for x, y in zip(ca_t, ca_j):
        _close(x, y)

    q_j, _ = junroll(
        lambda c, o, a, r: jcritic.apply(pc, o, a, c, r), jcarry,
        jnp.asarray(obs), jnp.asarray(act), jnp.asarray(reset),
    )
    q_t, _ = unroll(
        lambda c, o, a, r: critic.apply_params(tc, o, a, c, r), tcarry,
        _t(obs), _t(act), _t(reset),
    )
    assert q_t.shape == (T, B)
    _close(q_t, q_j)


def test_ensemble_axis_runs_stacked_params_as_separate_nets():
    """A [2] leading axis on every param applies two nets in one call (the
    port's stand-in for vmap over params in the fused burn-in)."""
    (_, _, actor, ta), _ = _nets(True)
    tb = actor.init_params(torch.Generator().manual_seed(3), "cpu")
    obs, _, reset, carry = _inputs(seed=2)
    c0 = carry_from_jax(carry)
    stacked = {k: torch.stack([ta[k], tb[k]]) for k in ta}
    c2 = tuple(torch.stack([x, x]) for x in c0)
    a2, (c, h) = actor.apply_params(stacked, _t(obs[1]), c2, _t(reset[1]))
    for i, p in enumerate((ta, tb)):
        a1, (c1, h1) = actor.apply_params(p, _t(obs[1]), c0, _t(reset[1]))
        _close(a2[i], a1)
        _close(c[i], c1)
        _close(h[i], h1)


def test_init_follows_the_ddpg_convention():
    net = CriticNet(OBS, ACT, hidden=HID)
    p = net.init_params(torch.Generator().manual_seed(0), "cpu")
    for k, v in p.items():
        if k.endswith("bias") or k == "core.cell.bh":
            assert torch.count_nonzero(v) == 0, k  # zero biases
    assert p["head.weight"].abs().max() <= 3e-3
    bound = 1.0 / np.sqrt(HID + ACT)
    assert p["mix.weight"].abs().max() <= bound
    # orthogonal per-gate recurrent kernels
    wh = p["core.cell.wh"][:HID]
    torch.testing.assert_close(wh @ wh.T, torch.eye(HID), atol=1e-5, rtol=0)
    # one seed, one set of params
    q = net.init_params(torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(p[k], q[k]) for k in p)


def test_zeros_where_reset_keeps_empty_carry_and_masks_rows():
    assert zeros_where_reset((), torch.ones(3)) == ()
    c = torch.ones(2, 3, 4)  # ensemble [2] x batch [3]
    (out,) = zeros_where_reset((c,), torch.tensor([0.0, 1.0, 0.0]))
    assert out[:, 1].abs().sum() == 0 and out[:, 0].sum() == 8
