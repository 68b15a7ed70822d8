"""The LSTM nets' sequence form against their step form, on the CPU.

The learner unrolls a float32 LSTM net over its whole window at once
(``_Net.apply_seq``): every layer but the recurrence over the window's
``T*B`` rows, the recurrence in one call of ``ops/lstm_seq.py`` (on a CPU
tensor its plain version; on a card one kernel launch each way, which
``tests/test_torch_cuda.py`` holds to that plain version).  Here the plain
sequence form is held to the step form (``unroll`` over ``apply_params``,
what the learner ran before and what collection and serving still run):
outputs, the final carry, the gradients of every parameter and of the
inputs, for the actor, the critic and the actor-through-critic loss, with
1, 2 and 4 ensemble members, resets at the first step, mid-window and at
every step, and hidden sizes 32, 128 and 256.  The two sum their products
in other orders (one product over ``T*B`` rows against ``T`` of ``B``), so
they agree to float32 rounding: measured within 7e-7 of each tensor's
largest magnitude, held to ``TOL`` of it.

A toy learner step with fused burn-in, with twin critics and TD3's
smoothing, and unfused, equals its step-form value to the same rounding,
and counts every unroll under ``r2d2dpg_lstm_unroll_total`` as the
sequence form; the bf16 nets keep the step form (reason
``mixed_precision``).  The FLOP count of an unroll (``count_flops``) is
the step form's.  The wrapper refuses what the kernel does not take.
"""

import numpy as np
import pytest
import torch

from r2d2dpg_torch.agents import AgentConfig, R2D2DPG
from r2d2dpg_torch.agents.ddpg import UNROLL_METRIC
from r2d2dpg_torch.models import ActorNet, CriticNet
from r2d2dpg_torch.models.actor_critic import _Core, unroll
from r2d2dpg_torch.obs import get_registry
from r2d2dpg_torch.obs.device import count_flops
from r2d2dpg_torch.ops.lstm_seq import (
    lstm_seq_bwd,
    lstm_seq_fwd,
    lstm_sequence,
    rows_per_cluster,
)
from r2d2dpg_torch.replay import SequenceBatch
from r2d2dpg_torch.tree import tree_leaves

T, B, OBS, ACT = 6, 3, 3, 2
TOL = 4e-6  # of the reference tensor's largest magnitude: float32 rounding
RESETS = ("start", "mid", "every")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the products are tiny, and the test workers
    share the machine's cores (more threads than cores make them crawl)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, what=""):
    got, want = got.detach(), want.detach()
    scale = float(want.abs().max()) or 1.0
    err = float((got - want).abs().max())
    assert err <= TOL * scale, f"{what}: {err} > {TOL} x {scale}"


def _reset(pattern, steps=T):
    r = torch.zeros(steps, B, dtype=torch.bool)
    if pattern == "start":
        r[0] = True
    elif pattern == "mid":
        r[steps // 2, 0] = r[steps // 2 + 1, 2] = True
    else:
        r[:] = True
    return r


def _step_route(monkeypatch):
    """Every LSTM core takes the step form, as before the sequence form."""
    monkeypatch.setattr(_Core, "unroll_route", property(lambda self: ("step", "test")))


def _params(net, members, seed):
    ps = [net.init_params(torch.Generator().manual_seed(seed + i), "cpu")
          for i in range(members)]
    if members == 1:
        return ps[0]
    return {k: torch.stack([p[k] for p in ps]) for k in ps[0]}


def _leafy(tree):
    return {k: v.detach().clone().requires_grad_() for k, v in tree.items()}


def _carry(members, hidden, rng):
    lead = () if members == 1 else (members,)
    return tuple(torch.from_numpy(0.5 * rng.standard_normal((*lead, B, hidden))
                                  .astype(np.float32)).requires_grad_() for _ in range(2))


def _grads(loss, leaves):
    return torch.autograd.grad(loss, leaves, allow_unused=True)


def _net_case(kind, members, hidden, pattern):
    """``run(sequence) -> (outputs, final carry, gradients)`` of one net
    (or the actor through the critic) on fixed inputs."""
    rng = np.random.default_rng(hidden + members)
    obs = torch.from_numpy(rng.standard_normal((T, B, OBS)).astype(np.float32))
    obs.requires_grad_()
    act = torch.from_numpy(rng.uniform(-1, 1, (T, B, ACT)).astype(np.float32))
    act.requires_grad_()
    reset = _reset(pattern)
    actor, critic = ActorNet(OBS, ACT, hidden=hidden), CriticNet(OBS, ACT, hidden=hidden)
    ap, cp = _leafy(_params(actor, members, 1)), _leafy(_params(critic, members, 11))
    ca, cc = _carry(members, hidden, rng), _carry(members, hidden, rng)
    lead = () if members == 1 else (members,)
    w_out = torch.from_numpy(rng.standard_normal((T, *lead, B, ACT)).astype(np.float32))

    def run(sequence):
        if kind == "actor":
            if sequence:
                out, carry = actor.apply_seq(ap, obs, ca, reset)
            else:
                out, carry = unroll(lambda c, o, r: actor.apply_params(ap, o, c, r),
                                    ca, obs, reset)
            loss = (out * w_out).sum()
            leaves = [*ap.values(), obs, *ca]
        elif kind == "critic":
            if sequence:
                out, carry = critic.apply_seq(cp, obs, act, cc, reset)
            else:
                out, carry = unroll(lambda c, o, a, r: critic.apply_params(cp, o, a, c, r),
                                    cc, obs, act, reset)
            loss = (out * w_out[..., 0]).sum()
            leaves = [*cp.values(), obs, act, *cc]
        else:  # the actor-loss unroll: a_t = mu(o_t), q_t = Q(o_t, a_t)
            agent = R2D2DPG(actor, critic, AgentConfig(burnin=0, unroll=T, n_step=1,
                                                       fused_burnin=False))
            if not sequence:
                assert not agent._both_sequence()
            a, out, carry = agent._unroll_pi_q(ap, cp, ca, cc, obs, reset)
            loss = -out.mean() + 0.1 * (a * w_out).sum()
            leaves = [*ap.values(), *cp.values(), obs, *ca, *cc]
        loss = loss + sum((0.3 + i) * x.sum() for i, x in enumerate(tree_leaves(carry)))
        return out, carry, _grads(loss, leaves)

    return run


@pytest.mark.parametrize("hidden", [32, 128, 256])
@pytest.mark.parametrize("pattern", RESETS)
@pytest.mark.parametrize("members", [1, 2, 4])
@pytest.mark.parametrize("kind", ["actor", "critic", "pi_q"])
def test_sequence_form_matches_the_step_form(kind, members, pattern, hidden, monkeypatch):
    run = _net_case(kind, members, hidden, pattern)
    out, carry, grads = run(sequence=True)
    with monkeypatch.context() as m:
        _step_route(m)
        want_out, want_carry, want_grads = run(sequence=False)
    assert out.shape == want_out.shape
    _close(out, want_out, "outputs")
    for got, want in zip(tree_leaves(carry), tree_leaves(want_carry), strict=True):
        _close(got, want, "final carry")
    for i, (got, want) in enumerate(zip(grads, want_grads, strict=True)):
        assert (got is None) == (want is None)
        if want is not None:
            _close(got, want, f"gradient {i}")


@pytest.mark.parametrize("members", [1, 2])
def test_dense_core_sequence_matches_the_step_form(members):
    critic = CriticNet(OBS, ACT, hidden=32, use_lstm=False)
    cp = _params(critic, members, 3)
    rng = np.random.default_rng(members)
    obs = torch.from_numpy(rng.standard_normal((T, B, OBS)).astype(np.float32))
    act = torch.from_numpy(rng.uniform(-1, 1, (T, B, ACT)).astype(np.float32))
    reset = _reset("mid")
    q, carry = critic.apply_seq(cp, obs, act, (), reset)
    want, _ = unroll(lambda c, o, a, r: critic.apply_params(cp, o, a, c, r), (), obs, act, reset)
    assert carry == () and critic.sequence_form
    _close(q, want)


def _learner_case(kind, dtype=torch.float32):
    hid = 32
    kw = {"fused": {}, "unfused": {"fused_burnin": False},
          "td3": {"twin_critic": True, "target_policy_sigma": 0.2}}[kind]
    cfg = AgentConfig(burnin=3, unroll=4, n_step=2, **kw)
    agent = R2D2DPG(ActorNet(OBS, ACT, hidden=hid, dtype=dtype),
                    CriticNet(OBS, ACT, hidden=hid, dtype=dtype), cfg)
    rng = np.random.default_rng(5)
    L, rows = cfg.seq_len, 8
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32))  # noqa: E731
    carry = lambda: (t(0.5 * rng.standard_normal((rows, hid))),  # noqa: E731
                     t(0.5 * rng.standard_normal((rows, hid))))
    batch = SequenceBatch(
        obs=t(rng.standard_normal((rows, L, OBS))),
        action=t(rng.uniform(-1, 1, (rows, L, ACT))),
        reward=t(rng.standard_normal((rows, L))),
        discount=t(rng.random((rows, L)) > 0.05),
        reset=t(rng.random((rows, L)) < 0.15),
        carries={"actor": carry(), "critic": carry()},
    )
    w = t(rng.uniform(0.2, 1.0, rows))
    normal = (t(rng.standard_normal((cfg.unroll + cfg.n_step, rows, ACT)))
              if cfg.target_policy_sigma > 0 else None)
    state = agent.init(torch.Generator().manual_seed(2), "cpu")
    return agent, state, batch, w, normal


def _unroll_counts():
    inst = get_registry().get(UNROLL_METRIC)
    return {} if inst is None else {k: c.value for k, c in inst._cells_snapshot()}


def _counted(before):
    return {k: v - before.get(k, 0.0) for k, v in _unroll_counts().items()
            if v != before.get(k, 0.0)}


# Unrolls a learner step runs: burn-in (one a net fused, two unfused), the
# targets' actor and critic, the critic's forward, the actor loss's actor
# and critic.
UNROLLS = {"fused": 2 + 5, "unfused": 4 + 5, "td3": 2 + 5}


@pytest.mark.parametrize("kind", ["fused", "unfused", "td3"])
def test_learner_step_in_the_sequence_form_matches_the_step_form(kind, monkeypatch):
    agent, state, batch, w, normal = _learner_case(kind)
    assert agent.actor.sequence_form and agent.critic.sequence_form
    before = _unroll_counts()
    got = agent.learner_step(state, batch, w, normal)
    assert _counted(before) == {("sequence", "float32"): float(UNROLLS[kind])}
    with monkeypatch.context() as m:
        _step_route(m)
        before = _unroll_counts()
        want = agent.learner_step(state, batch, w, normal)
        assert _counted(before) == {("step", "test"): float(UNROLLS[kind])}
    new, prios, metrics = got
    for name in ("actor_params", "critic_params", "target_actor_params",
                 "target_critic_params"):
        for k, v in getattr(want[0], name).items():
            _close(getattr(new, name)[k], v, f"{name}.{k}")
    for k, v in want[0].critic_opt_state.mu.items():
        _close(new.critic_opt_state.mu[k], v, f"critic first moment {k}")
    _close(prios, want[1], "priorities")
    for k, v in want[2].items():
        _close(metrics[k], v, k)


def test_initial_priority_in_the_sequence_form_matches_the_step_form(monkeypatch):
    agent, state, batch, _, _ = _learner_case("td3")
    got = agent.initial_priority(state, batch)
    with monkeypatch.context() as m:
        _step_route(m)
        want = agent.initial_priority(state, batch)
    _close(got, want)


def test_bf16_nets_keep_the_step_form():
    agent, state, batch, w, normal = _learner_case("fused", dtype=torch.bfloat16)
    assert not agent.actor.sequence_form and not agent.critic.sequence_form
    assert agent.actor.core.unroll_route == ("step", "mixed_precision")
    before = _unroll_counts()
    agent.learner_step(state, batch, w, normal)
    assert _counted(before) == {("step", "mixed_precision"): float(UNROLLS["fused"])}


@pytest.mark.parametrize("members", [1, 4])
def test_flop_count_of_an_unroll_is_the_step_forms(members, monkeypatch):
    """``count_flops`` of a critic unroll and its parameters' gradient
    counts the recurrence's products as the step form does (the learner's
    unrolls start from a carry that takes no gradient)."""
    critic = CriticNet(OBS, ACT, hidden=32)
    cp = _leafy(_params(critic, members, 4))
    rng = np.random.default_rng(members)
    obs = torch.from_numpy(rng.standard_normal((T, B, OBS)).astype(np.float32))
    act = torch.from_numpy(rng.uniform(-1, 1, (T, B, ACT)).astype(np.float32))
    carry = tuple(x.detach() for x in _carry(members, 32, rng))
    reset = _reset("mid")

    def run(sequence):
        if sequence:
            q, _ = critic.apply_seq(cp, obs, act, carry, reset)
        else:
            q, _ = unroll(lambda c, o, a, r: critic.apply_params(cp, o, a, c, r),
                          carry, obs, act, reset)
        return torch.autograd.grad(q.square().sum(), list(cp.values()))

    _, got = count_flops(run, sequence=True)
    with monkeypatch.context() as m:
        _step_route(m)
        _, want = count_flops(run, sequence=False)
    assert got == want > 0


def test_no_gradient_saves_nothing_and_the_carry_gradient_is_optional():
    rng = np.random.default_rng(0)
    e, h = 2, 32
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    zx, wh, bh, c0, h0 = t(e, T, B, 4 * h), t(e, 4 * h, h), t(e, 4 * h), t(e, B, h), t(e, B, h)
    reset = _reset("mid")
    y, c_last, gates, cs = lstm_seq_fwd(zx, wh, bh, c0, h0, reset, False)
    assert gates.numel() == cs.numel() == 0 and y.shape == (e, T, B, h)
    y2, c2, gates, cs = lstm_seq_fwd(zx, wh, bh, c0, h0, reset, True)
    assert torch.equal(y, y2) and torch.equal(c_last, c2)
    assert gates.shape == zx.shape and cs.shape == y.shape
    dy, dc = t(e, T, B, h), t(e, B, h)
    dz, dc0, dh0 = lstm_seq_bwd(dy, dc, wh, gates, cs, c0, reset, False)
    dz2, dc0, dh0 = lstm_seq_bwd(dy, dc, wh, gates, cs, c0, reset, True)
    assert torch.equal(dz, dz2) and dc0.shape == dh0.shape == c0.shape


def test_one_carry_serves_every_member():
    """Stacked params with one unstacked carry: each member starts from it,
    as the step form's broadcast does."""
    rng = np.random.default_rng(1)
    e, h = 2, 32
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    zx, wh, bh, c0, h0 = t(e, T, B, 4 * h), t(e, 4 * h, h), t(e, 4 * h), t(B, h), t(B, h)
    reset = _reset("start")
    reset[0] = False
    y, (c, hl) = lstm_sequence(zx, wh, bh, (c0, h0), reset)
    want, _ = lstm_sequence(zx, wh, bh, (c0.expand(e, B, h), h0.expand(e, B, h)), reset)
    assert torch.equal(y, want) and y.shape == (e, T, B, h) and c.shape == (e, B, h)


def _args(e=1, t=4, b=3, h=32):
    z = lambda *s: torch.zeros(s)  # noqa: E731
    return [z(e, t, b, 4 * h), z(e, 4 * h, h), z(e, 4 * h), z(e, b, h), z(e, b, h),
            torch.zeros(t, b, dtype=torch.bool), False]


@pytest.mark.parametrize("case", ["wh_rank", "zx_width", "reset_shape", "bias_shape",
                                  "carry_shape", "float64", "reset_dtype", "no_steps"])
def test_the_op_refuses_what_it_does_not_take(case):
    args = _args(t=0) if case == "no_steps" else _args()
    if case == "wh_rank":
        args[1] = args[1][0]
    elif case == "zx_width":
        args[0] = torch.zeros(1, 4, 3, 64)
    elif case == "reset_shape":
        args[5] = torch.zeros(4, 2, dtype=torch.bool)
    elif case == "bias_shape":
        args[2] = torch.zeros(1, 64)
    elif case == "carry_shape":
        args[3] = torch.zeros(1, 2, 32)
    elif case == "float64":
        args[:5] = [a.double() for a in args[:5]]
    elif case == "reset_dtype":
        args[5] = args[5].float()
    with pytest.raises((ValueError, TypeError), match="lstm_seq"):
        lstm_seq_fwd(*args)


@pytest.mark.parametrize("members,batch,hidden,want", [
    (1, 64, 256, 4),    # walker_r2d2: the critic's and actor's unrolls
    (2, 64, 256, 8),    # walker_r2d2's fused burn-in
    (4, 64, 256, 16),   # TD3's fused burn-in
    (1, 32, 256, 2),    # cheetah_pixels
    (1, 256, 256, 16),  # past the card: clusters run in waves
    (1, 1024, 256, 16),  # a wide batch: more waves, no other limit
    (1, 64, 32, 2),     # pendulum_tiny
])
def test_rows_per_cluster_fill_the_card(members, batch, hidden, want):
    assert rows_per_cluster(members, batch, hidden, 132) == want
