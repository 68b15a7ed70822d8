"""Port parity: the pixel CNN torso and the pixel learner against the JAX package.

The flax nets are initialized by JAX; their params go through
``r2d2dpg_torch.convert`` into the port's nets, and both packages run the
same numpy inputs (made from a seed): frames of 36x36 (the smallest the
conv stack accepts) and 64x64 (cheetah_pixels), uint8 and float32.

Tolerances: nets and torso rtol 1e-5, atol 1e-6 (as tests/test_torch_models.py:
float32 products summed in another order, here over up to 8*8*3 = 192 terms
per conv output); the learner step chain as tests/test_torch_agent.py
(params atol 1e-5, rtol 1e-4).  The heads' U(±3e-3) init makes actions and
Q tiny, so the nets' heads are scaled by 100 before comparing: a mismatch
in the torso then shows in the outputs at the stated tolerance.

cuDNN TF32 is switched off, as ``resolve_device`` does on a card.
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
from r2d2dpg_tpu.models import unroll as junroll
from r2d2dpg_tpu.models.torsos import ConvTorso as JConvTorso
from r2d2dpg_tpu.replay.arena import SequenceBatch as JBatch
from r2d2dpg_torch.agents import AgentConfig, R2D2DPG
from r2d2dpg_torch.convert import (
    net_params_from_flax,
    sequence_batch_from_jax,
    train_state_from_jax,
)
from r2d2dpg_torch.models import ActorNet, ConvTorso, CriticNet, unroll
from r2d2dpg_torch.models.torsos import Conv

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

B, ACT, HID, T = 3, 2, 32, 5
RTOL, ATOL = 1e-5, 1e-6
FRAMES = [(36, np.uint8), (36, np.float32), (64, np.uint8), (64, np.float32)]


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _frames(rng, lead, size, dtype):
    shape = lead + (size, size, 3)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape).astype(np.uint8)
    return rng.uniform(0.0, 1.0, shape).astype(np.float32)


def _inputs(size, dtype, seed=0):
    rng = np.random.default_rng(seed)
    obs = _frames(rng, (T, B), size, dtype)
    act = rng.uniform(-1, 1, (T, B, ACT)).astype(np.float32)
    reset = (rng.random((T, B)) < 0.3).astype(np.float32)
    reset[0] = 0.0
    carry = tuple(rng.standard_normal((B, HID)).astype(np.float32) for _ in range(2))
    return obs, act, reset, carry


def _scale_head(params, factor=100.0):
    params["params"]["head"]["kernel"] = params["params"]["head"]["kernel"] * factor
    return params


def _nets(size, dtype):
    """(flax actor, its params, port actor, converted) and the same for the critic."""
    shape = (size, size, 3)
    jactor = JActor(action_dim=ACT, hidden=HID, pixels=True)
    jcritic = JCritic(hidden=HID, pixels=True)
    obs0 = jnp.zeros((B,) + shape, dtype)
    reset0 = jnp.zeros((B,))
    carry0 = jactor.initial_carry(B)
    ka, kc = jax.random.split(jax.random.PRNGKey(11))
    pa = _scale_head(jax.device_get(jactor.init(ka, obs0, carry0, reset0)))
    pc = _scale_head(
        jax.device_get(jcritic.init(kc, obs0, jnp.zeros((B, ACT)), carry0, reset0))
    )
    actor = ActorNet(shape, ACT, hidden=HID, pixels=True)
    critic = CriticNet(shape, ACT, hidden=HID, pixels=True)
    return (jactor, pa, actor, net_params_from_flax(pa)), (
        jcritic, pc, critic, net_params_from_flax(pc)
    )


def _torso_params(params):
    return {k[len("torso."):]: v for k, v in params.items() if k.startswith("torso.")}


@pytest.mark.parametrize("size,dtype", FRAMES)
def test_conv_torso_matches_flax(size, dtype):
    (_, pa, actor, ta), _ = _nets(size, dtype)
    obs = _frames(np.random.default_rng(1), (T, B), size, dtype)  # [T, B, H, W, C]
    want = JConvTorso(out_size=HID).apply(
        {"params": pa["params"]["torso"]}, jnp.asarray(obs)
    )
    torso = actor.torso
    assert isinstance(torso, ConvTorso)
    got = torch.func.functional_call(torso, _torso_params(ta), (torch.tensor(obs),))
    assert got.shape == (T, B, HID)
    _close(got, want)


@pytest.mark.parametrize("size,dtype", FRAMES)
def test_pixel_nets_single_step_match_flax(size, dtype):
    (jactor, pa, actor, ta), (jcritic, pc, critic, tc) = _nets(size, dtype)
    obs, act, reset, carry = _inputs(size, dtype)
    jcarry = tuple(jnp.asarray(x) for x in carry)
    tcarry = tuple(torch.tensor(x) for x in carry)
    a_j, ca_j = jactor.apply(pa, jnp.asarray(obs[1]), jcarry, jnp.asarray(reset[1]))
    a_t, ca_t = actor.apply_params(ta, torch.tensor(obs[1]), tcarry, torch.tensor(reset[1]))
    _close(a_t, a_j)
    for x, y in zip(ca_t, ca_j):
        _close(x, y)
    q_j, cc_j = jcritic.apply(
        pc, jnp.asarray(obs[1]), jnp.asarray(act[1]), jcarry, jnp.asarray(reset[1])
    )
    q_t, cc_t = critic.apply_params(
        tc, torch.tensor(obs[1]), torch.tensor(act[1]), tcarry, torch.tensor(reset[1])
    )
    assert q_t.shape == (B,)
    _close(q_t, q_j)
    for x, y in zip(cc_t, cc_j):
        _close(x, y)


@pytest.mark.parametrize("size,dtype", FRAMES)
def test_pixel_unroll_with_mid_sequence_resets_matches_flax(size, dtype):
    (jactor, pa, actor, ta), (jcritic, pc, critic, tc) = _nets(size, dtype)
    obs, act, reset, carry = _inputs(size, dtype, seed=2)
    jcarry = tuple(jnp.asarray(x) for x in carry)
    tcarry = tuple(torch.tensor(x) for x in carry)
    a_j, ca_j = junroll(
        lambda c, o, r: jactor.apply(pa, o, c, r), jcarry,
        jnp.asarray(obs), jnp.asarray(reset),
    )
    a_t, ca_t = unroll(
        lambda c, o, r: actor.apply_params(ta, o, c, r), tcarry,
        torch.tensor(obs), torch.tensor(reset),
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
        torch.tensor(obs), torch.tensor(act), torch.tensor(reset),
    )
    assert q_t.shape == (T, B)
    _close(q_t, q_j)


def test_conv_ensemble_axis_runs_stacked_params_as_separate_nets():
    """A [2] leading axis on every param runs two pixel critics in one grouped
    convolution per layer, each member on the same frames."""
    (_, _, _, _), (_, _, critic, tc) = _nets(36, np.uint8)
    tb = critic.init_params(torch.Generator().manual_seed(3), "cpu")
    obs, act, reset, carry = _inputs(36, np.uint8, seed=4)
    c0 = tuple(torch.tensor(x) for x in carry)
    stacked = {k: torch.stack([tc[k], tb[k]]) for k in tc}
    c2 = tuple(torch.stack([x, x]) for x in c0)
    args = (torch.tensor(obs[1]), torch.tensor(act[1]))
    q2, (c, h) = critic.apply_params(stacked, *args, c2, torch.tensor(reset[1]))
    assert q2.shape == (2, B)
    for i, p in enumerate((tc, tb)):
        q1, (c1, h1) = critic.apply_params(p, *args, c0, torch.tensor(reset[1]))
        _close(q2[i], q1)
        _close(c[i], c1)
        _close(h[i], h1)


@pytest.mark.parametrize("size", [36, 64])
def test_converter_round_trip(size):
    """flax HWIO conv kernels -> OIHW fill the port's nets exactly, and the
    inverse permutation gives the flax kernels back bit for bit."""
    (_, pa, actor, ta), (_, pc, critic, tc) = _nets(size, np.uint8)
    for net, flax_params, params in ((actor, pa, ta), (critic, pc, tc)):
        want = {k: tuple(v.shape) for k, v in net.named_parameters()}
        assert {k: tuple(v.shape) for k, v in params.items()} == want
        torso = flax_params["params"]["torso"]
        for i in range(3):
            back = params[f"torso.convs.{i}.weight"].numpy().transpose(2, 3, 1, 0)
            np.testing.assert_array_equal(back, torso[f"Conv_{i}"]["kernel"])
            np.testing.assert_array_equal(
                params[f"torso.convs.{i}.bias"].numpy(), torso[f"Conv_{i}"]["bias"]
            )
        np.testing.assert_array_equal(
            params["torso.dense.weight"].numpy().T, torso["Dense_0"]["kernel"]
        )


def test_conv_init_is_lecun_normal_over_in_kh_kw():
    """Variance 1/(in*kH*kW), truncated at ±2 std of the untruncated normal."""
    conv = Conv(64, 512, 3, 1)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    w = conv.weight.detach().double()
    fan_in = 64 * 3 * 3
    n = w.numel()
    var = 1.0 / fan_in
    assert abs(w.mean().item()) < 4 * np.sqrt(var / n)
    assert abs(w.var().item() / var - 1.0) < 0.02
    assert w.abs().max().item() <= 2 * np.sqrt(var) / 0.87962566103423978 + 1e-9
    assert torch.count_nonzero(conv.bias) == 0


# --------------------------------------------------------------- the learner
def _pixel_agents(size=36):
    cfg = dict(burnin=2, unroll=4, n_step=2)
    jagent = JAgent(
        JActor(action_dim=ACT, hidden=HID, pixels=True),
        JCritic(hidden=HID, pixels=True),
        JConfig(**cfg),
    )
    shape = (size, size, 3)
    tagent = R2D2DPG(
        ActorNet(shape, ACT, hidden=HID, pixels=True),
        CriticNet(shape, ACT, hidden=HID, pixels=True),
        AgentConfig(**cfg),
    )
    return jagent, tagent


def _pixel_batch(agent, size=36, b=4, seed=0):
    rng = np.random.default_rng(seed)
    L = agent.config.seq_len
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return JBatch(
        obs=jnp.asarray(_frames(rng, (b, L), size, np.uint8)),
        action=jnp.asarray(rng.uniform(-1, 1, (b, L, ACT)).astype(np.float32)),
        reward=jnp.asarray(f(b, L)),
        discount=jnp.asarray((rng.random((b, L)) > 0.05).astype(np.float32)),
        reset=jnp.asarray((rng.random((b, L)) < 0.15).astype(np.float32)),
        carries={
            "actor": (jnp.asarray(0.5 * f(b, HID)), jnp.asarray(0.5 * f(b, HID))),
            "critic": (jnp.asarray(0.5 * f(b, HID)), jnp.asarray(0.5 * f(b, HID))),
        },
    )


def test_pixel_learner_step_chain_matches_jax():
    from test_torch_agent import METRIC_TOL, _state_close

    jagent, tagent = _pixel_agents()
    jbatch = _pixel_batch(jagent)
    jstate = jagent.init(jax.random.PRNGKey(3), jbatch.obs[:, 0], jbatch.action[:, 0])
    tbatch = sequence_batch_from_jax(jax.device_get(jbatch))
    tstate = train_state_from_jax(jax.device_get(jstate))
    w = np.random.default_rng(9).uniform(0.2, 1.0, 4).astype(np.float32)
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
