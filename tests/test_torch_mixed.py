"""Port parity: the bf16 mixed-precision nets and learner against JAX.

Modelled on tests/test_models.py's bf16 tests.  Inputs come from a numpy
seed; flax params go through ``r2d2dpg_torch.convert``.

Tolerances and why:

- ``MixedPrecisionLSTMCell`` (bf16 and float32): rtol 1e-5, atol 1e-6 over
  a 12-step unroll.  Both sides round the same float32 operands to bf16 and
  multiply exactly, so only the float32 sums' order differs.
- bf16 nets (MLP and 36x36 pixel torso): rtol 1e-2, atol 2e-3 on actions,
  Q and carries, heads scaled by 100 so the outputs are O(1).  Every Dense
  and conv rounds its result to bf16 (8 bits of mantissa, a relative step
  of 2**-8 = 0.0039); torch and XLA:CPU sum in other orders, so a result
  near a rounding boundary can land one bf16 step apart, and that step
  travels on.
- One bf16 learner step: the losses, metrics and priorities rtol 2e-2,
  atol 1e-3; the gradients before Adam within 3 % of each tensor's largest
  gradient.  Adam's first step moves each param by about ``sign(g) * lr``,
  so where a gradient near 0 takes the other sign the params differ by up
  to ``2 * lr``: params are compared in units of ``lr`` (at most 2.05
  apart, and more than 0.01 apart only where JAX's gradient is within
  that 3 % of 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from r2d2dpg_tpu.agents import AgentConfig as JConfig
from r2d2dpg_tpu.agents import R2D2DPG as JAgent
from r2d2dpg_tpu.models import ActorNet as JActor
from r2d2dpg_tpu.models import CriticNet as JCritic
from r2d2dpg_tpu.models import unroll as junroll
from r2d2dpg_tpu.models.actor_critic import MixedPrecisionLSTMCell as JCell
from r2d2dpg_torch.agents import AgentConfig, R2D2DPG
from r2d2dpg_torch.convert import (
    lstm_cell_params_from_flax,
    net_params_from_flax,
    sequence_batch_from_jax,
    train_state_from_jax,
)
from r2d2dpg_torch.models import (
    ActorNet,
    CriticNet,
    LSTMCell,
    MixedPrecisionLSTMCell,
    unroll,
)

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

B, OBS, ACT, HID, T = 5, 3, 2, 32, 9
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "float32": (jnp.float32, torch.float32)}
NET_TOL = dict(rtol=1e-2, atol=2e-3)
CELL_TOL = dict(rtol=1e-5, atol=1e-6)


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mixed_cell_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    steps, in_features = 12, 7
    xs = (0.5 * rng.standard_normal((steps, B, in_features))).astype(np.float32)
    c0 = tuple(rng.standard_normal((B, HID)).astype(np.float32) for _ in range(2))
    jcell = JCell(HID, dtype=jdt)
    jcarry = tuple(jnp.asarray(x) for x in c0)
    params = jax.device_get(jcell.init(jax.random.PRNGKey(1), jcarry, jnp.asarray(xs[0])))
    cell = MixedPrecisionLSTMCell(in_features, HID, tdt)
    tparams = lstm_cell_params_from_flax(params)
    tcarry = tuple(torch.tensor(x) for x in c0)
    for t in range(steps):
        jcarry, jy = jcell.apply(params, jcarry, jnp.asarray(xs[t]))
        tcarry, ty = torch.func.functional_call(cell, tparams, (tcarry, torch.tensor(xs[t])))
        assert ty.dtype == tdt
        np.testing.assert_allclose(_np(ty.float()), _np(jy), **CELL_TOL)
        for x, y in zip(tcarry, jcarry):
            assert x.dtype == torch.float32
            np.testing.assert_allclose(x.numpy(), _np(y), **CELL_TOL)


def test_bf16_net_keeps_fp32_carry_and_outputs():
    actor = ActorNet(OBS, ACT, hidden=HID, dtype=torch.bfloat16)
    critic = CriticNet(OBS, ACT, hidden=HID, dtype=torch.bfloat16)
    assert isinstance(actor.core.cell, MixedPrecisionLSTMCell)
    assert type(ActorNet(OBS, ACT, hidden=HID).core.cell) is LSTMCell  # fp32 path kept
    pa = actor.init_params(torch.Generator().manual_seed(0), "cpu")
    pc = critic.init_params(torch.Generator().manual_seed(1), "cpu")
    assert all(v.dtype == torch.float32 for v in (*pa.values(), *pc.values()))
    ca = cc = actor.initial_carry(B, "cpu")
    reset = torch.zeros(B)
    for i in range(3):
        obs = torch.full((B, OBS), float(i))
        action, ca = actor.apply_params(pa, obs, ca, reset)
        q, cc = critic.apply_params(pc, obs, action, cc, reset)
    assert action.dtype == torch.float32 and q.dtype == torch.float32
    assert all(x.dtype == torch.float32 for x in (*ca, *cc))


def _scaled(params):
    params["params"]["head"]["kernel"] = params["params"]["head"]["kernel"] * 100.0
    return params


@pytest.mark.parametrize("pixels", [False, True])
def test_bf16_nets_match_jax_bf16_nets(pixels):
    rng = np.random.default_rng(3)
    shape = (36, 36, 3) if pixels else (OBS,)
    if pixels:
        obs = rng.integers(0, 256, (T, B) + shape).astype(np.uint8)
    else:
        obs = rng.standard_normal((T, B) + shape).astype(np.float32)
    act = rng.uniform(-1, 1, (T, B, ACT)).astype(np.float32)
    reset = (rng.random((T, B)) < 0.25).astype(np.float32)
    reset[0] = 0.0
    carry = tuple(rng.standard_normal((B, HID)).astype(np.float32) for _ in range(2))
    jactor = JActor(action_dim=ACT, hidden=HID, pixels=pixels, dtype=jnp.bfloat16)
    jcritic = JCritic(hidden=HID, pixels=pixels, dtype=jnp.bfloat16)
    jcarry = tuple(jnp.asarray(x) for x in carry)
    o0, r0 = jnp.asarray(obs[0]), jnp.asarray(reset[0])
    pa = _scaled(jax.device_get(jactor.init(jax.random.PRNGKey(1), o0, jcarry, r0)))
    pc = _scaled(jax.device_get(
        jcritic.init(jax.random.PRNGKey(2), o0, jnp.asarray(act[0]), jcarry, r0)
    ))
    net_shape = shape if pixels else OBS
    actor = ActorNet(net_shape, ACT, hidden=HID, pixels=pixels, dtype=torch.bfloat16)
    critic = CriticNet(net_shape, ACT, hidden=HID, pixels=pixels, dtype=torch.bfloat16)
    ta, tc = net_params_from_flax(pa), net_params_from_flax(pc)
    tcarry = tuple(torch.tensor(x) for x in carry)

    a_j, ca_j = jactor.apply(pa, jnp.asarray(obs[1]), jcarry, jnp.asarray(reset[1]))
    a_t, ca_t = actor.apply_params(ta, torch.tensor(obs[1]), tcarry, torch.tensor(reset[1]))
    np.testing.assert_allclose(a_t.numpy(), _np(a_j), **NET_TOL)
    for x, y in zip(ca_t, ca_j):
        np.testing.assert_allclose(x.numpy(), _np(y), **NET_TOL)

    a_j, ca_j = junroll(lambda c, o, r: jactor.apply(pa, o, c, r), jcarry,
                        jnp.asarray(obs), jnp.asarray(reset))
    a_t, ca_t = unroll(lambda c, o, r: actor.apply_params(ta, o, c, r), tcarry,
                       torch.tensor(obs), torch.tensor(reset))
    assert a_t.dtype == torch.float32
    np.testing.assert_allclose(a_t.numpy(), _np(a_j), **NET_TOL)
    for x, y in zip(ca_t, ca_j):
        np.testing.assert_allclose(x.numpy(), _np(y), **NET_TOL)
    q_j, cc_j = junroll(lambda c, o, a, r: jcritic.apply(pc, o, a, c, r), jcarry,
                        jnp.asarray(obs), jnp.asarray(act), jnp.asarray(reset))
    q_t, cc_t = unroll(lambda c, o, a, r: critic.apply_params(tc, o, a, c, r), tcarry,
                       torch.tensor(obs), torch.tensor(act), torch.tensor(reset))
    assert q_t.dtype == torch.float32 and q_t.shape == (T, B)
    np.testing.assert_allclose(q_t.numpy(), _np(q_j), **NET_TOL)
    for x, y in zip(cc_t, cc_j):
        np.testing.assert_allclose(x.numpy(), _np(y), **NET_TOL)


@pytest.mark.parametrize("pixels", [False, True])
def test_fp32_and_bf16_param_trees_interchange(pixels):
    """JAX params initialized under either dtype convert to the same port
    tree (names, shapes, float32), and run under the port net of the other."""
    shape = (36, 36, 3) if pixels else (OBS,)
    obs = jnp.zeros((B,) + shape, jnp.uint8 if pixels else jnp.float32)
    reset = jnp.zeros((B,))
    trees = {}
    for name, (jdt, _) in DTYPES.items():
        net = JActor(action_dim=ACT, hidden=HID, pixels=pixels, dtype=jdt)
        p = net.init(jax.random.PRNGKey(0), obs, net.initial_carry(B), reset)
        trees[name] = net_params_from_flax(jax.device_get(p))
    net_shape = shape if pixels else OBS
    ports = {name: ActorNet(net_shape, ACT, hidden=HID, pixels=pixels, dtype=tdt)
             for name, (_, tdt) in DTYPES.items()}
    want = {k: (tuple(v.shape), v.dtype) for k, v in ports["float32"].named_parameters()}
    for name in DTYPES:
        assert {k: (tuple(v.shape), v.dtype) for k, v in trees[name].items()} == want
        assert {k: (tuple(v.shape), v.dtype)
                for k, v in ports[name].named_parameters()} == want
    carry = ports["float32"].initial_carry(B, "cpu")
    tobs = torch.zeros((B,) + shape, dtype=torch.uint8 if pixels else torch.float32)
    for src, dst in (("float32", "bfloat16"), ("bfloat16", "float32")):
        a, c = ports[dst].apply_params(trees[src], tobs, carry, torch.zeros(B))
        assert a.shape == (B, ACT) and a.dtype == torch.float32
        assert all(x.dtype == torch.float32 for x in c)


# --------------------------------------------------------- the bf16 learner
def _bf16_agents():
    """Learners at tests/test_torch_agent.py's shapes (its ``_batch`` feeds them)."""
    from test_torch_agent import ACT as A, OBS as O

    cfg = dict(burnin=2, unroll=4, n_step=2)
    jagent = JAgent(
        JActor(action_dim=A, hidden=HID, dtype=jnp.bfloat16),
        JCritic(hidden=HID, dtype=jnp.bfloat16),
        JConfig(**cfg),
    )
    tagent = R2D2DPG(
        ActorNet(O, A, hidden=HID, dtype=torch.bfloat16),
        CriticNet(O, A, hidden=HID, dtype=torch.bfloat16),
        AgentConfig(**cfg),
    )
    return jagent, tagent


def _capture_grads():
    """An optax transform whose state after ``update`` IS the gradient."""
    return optax.GradientTransformation(
        init=lambda params: params,
        update=lambda g, state, params=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


GRAD_TOL = 0.03  # of each tensor's largest gradient


@pytest.fixture(scope="module")
def bf16_setup():
    """The step's inputs, and JAX's gradients: both optimizers swapped for
    one whose new state is the raw gradient."""
    from test_torch_agent import B as batch_size, _batch

    jagent, _ = _bf16_agents()
    jbatch = _batch(jagent, seed=4)
    jstate = jagent.init(jax.random.PRNGKey(3), jbatch.obs[:, 0], jbatch.action[:, 0])
    w = np.random.default_rng(9).uniform(0.2, 1.0, batch_size).astype(np.float32)
    capture, _ = _bf16_agents()
    capture.actor_tx = capture.critic_tx = _capture_grads()
    js = jax.jit(capture.learner_step)(jstate, jbatch, jnp.asarray(w))[0]
    grads = {
        "actor_params": net_params_from_flax(jax.device_get(js.actor_opt_state)),
        "critic_params": net_params_from_flax(jax.device_get(js.critic_opt_state)),
    }
    return jagent, jbatch, jstate, w, grads


def _port_inputs(jstate, jbatch):
    return (train_state_from_jax(jax.device_get(jstate)),
            sequence_batch_from_jax(jax.device_get(jbatch)))


def test_bf16_gradients_match_jax(bf16_setup):
    _, jbatch, jstate, w, grads = bf16_setup
    _, tagent = _bf16_agents()
    tagent._optimize = lambda params, g, opt_state, lr: (params, g)
    ts = tagent.learner_step(*_port_inputs(jstate, jbatch), torch.from_numpy(w))[0]
    for name, got in (("actor_params", ts.actor_opt_state),
                      ("critic_params", ts.critic_opt_state)):
        assert set(got) == set(grads[name])
        for k, g in grads[name].items():
            scale = g.abs().max().item()
            err = (got[k] - g).abs().max().item()
            assert err <= GRAD_TOL * scale + 1e-8, (name, k, err, scale)


def test_bf16_learner_step_matches_jax(bf16_setup):
    """Losses, metrics and priorities within 2 %; params within ``2 * lr``,
    and more than 0.01 lr apart only where JAX's gradient lies within the
    gradient tolerance of 0 (its sign is not settled at bf16)."""
    jagent, jbatch, jstate, w, grads = bf16_setup
    _, tagent = _bf16_agents()
    jnew, jprio, jm = jax.jit(jagent.learner_step)(jstate, jbatch, jnp.asarray(w))
    tnew, tprio, tm = tagent.learner_step(*_port_inputs(jstate, jbatch), torch.from_numpy(w))
    jm = jax.device_get(jm)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-2, atol=1e-3,
                                   err_msg=k)
    np.testing.assert_allclose(tprio.numpy(), np.asarray(jprio), rtol=2e-2, atol=1e-3)
    cfg = tagent.config
    for name, lr in (("actor_params", cfg.actor_lr), ("critic_params", cfg.critic_lr)):
        want = net_params_from_flax(jax.device_get(getattr(jnew, name)))
        got = getattr(tnew, name)
        for k, v in want.items():
            off = (got[k] - v).abs() / lr
            assert off.max().item() <= 2.05, (name, k, off.max().item())
            g = grads[name][k]
            unsettled = g.abs() <= GRAD_TOL * g.abs().max()
            assert bool(((off <= 0.01) | unsettled).all()), (name, k)
