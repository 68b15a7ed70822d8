"""The Granite-4.0-H hybrid core (``models/granite.py``) on the CPU, at a small
size: d 64, MLP 128, 8 Mamba-2 heads of 16 with state 8 and conv 4, 4 query
and 2 KV heads of 16, one period cut to Mamba-2, attention, Mamba-2.

- The sequence form equals the step loop, with resets inside the sequence
  and a nonzero starting state; both equal the plain reference
  (``perfbench/models/granite_hybrid.py``, the only one) from zero start.
- One ``R2D2DPG.learner_step`` equals the reference's update; the
  reference in row blocks equals it over the whole batch.
- Zero-start replay stores no carry; a short ``Trainer`` run on the tensor
  Pendulum; the core's spans and state gauge; the paths that cannot run
  the core refuse it; the LSTM configs keep their carries.

Tolerances are relative to the largest value compared.  Program and
reference compute in float32 and sum in other orders (one product over
``T`` steps and ``B`` rows against one a step, the state-space-dual form's
``T x T`` products against the step's recurrence), a few ulps apart:
1e-5 is a hundred times that, and a reset left uncut (the planted fault
the check is there for) reads over a hundred times the tolerance.
"""

import dataclasses
import types

import pytest
import torch

from perfbench import inputs
from perfbench.models import granite_hybrid as G
from perfbench.reference import learner as L
from perfbench.reference.nets import Precision
from r2d2dpg_torch.agents.ddpg import AgentConfig, R2D2DPG, TrainState, adam_init
from r2d2dpg_torch.configs import CONFIGS, PENDULUM_TINY, ExperimentConfig, get_config
from r2d2dpg_torch.envs.core import EnvSpec
from r2d2dpg_torch.models import ActorNet, CriticNet, GraniteSpec, unroll
from r2d2dpg_torch.models import granite
from r2d2dpg_torch.replay.arena import SequenceBatch
from r2d2dpg_torch.training.draws import Draws
from r2d2dpg_torch.tree import tree_leaves, tree_nbytes

SPEC = GraniteSpec(hidden_size=64, shared_intermediate_size=128,
                   layer_types=("mamba", "attention", "mamba"), mamba_n_heads=8,
                   mamba_d_head=16, mamba_d_state=8, mamba_d_conv=4, num_attention_heads=4,
                   num_key_value_heads=2)
OBS, ACT, CONTEXT = 5, 3, 32
TOL = 1e-5
CONF = {"env": {"obs_shape": [OBS], "action_dim": ACT}, "num_hidden_layers": 3,
        **{f.name: getattr(SPEC, f.name) for f in dataclasses.fields(SPEC)},
        "layer_types": list(SPEC.layer_types)}


def _nets():
    kw = dict(hidden=64, use_lstm=False, core="granite_hybrid", granite=SPEC, context=CONTEXT)
    return ActorNet(OBS, ACT, **kw), CriticNet(OBS, ACT, **kw)


def _weights(seed=7):
    """The benchmark's weights with every RMSNorm weight in [0.5, 1.5], so
    the mixers' share of each layer's output is large."""
    w = inputs.make_weights(G.shapes(CONF), seed, "cpu")
    g = torch.Generator().manual_seed(seed)
    for net in w.values():
        for k, v in net.items():
            if k.endswith("norm.weight") or k.endswith("layernorm.weight"):
                net[k] = 0.5 + torch.rand(v.shape, generator=g)
    return w


def _inputs(t=9, b=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    obs = torch.randn(t, b, OBS, generator=g)
    act = torch.rand(t, b, ACT, generator=g) * 2 - 1
    reset = torch.zeros(t, b)
    if t == 9:  # resets at the start, inside, and on two steps running
        reset[3, 1] = reset[0, 2] = reset[7, 0] = reset[8, 0] = 1
    return obs, act, reset


def _close(got, want, tol=TOL):
    scale = max(float(want.abs().max()), 1e-30)
    return float((got - want).abs().max()) / scale <= tol


def _apply(net, w, obs, act, carry, reset, sequence):
    """The net over ``[T, B, ...]``: its sequence form, or its step in a loop."""
    xs = (obs,) if act is None else (obs, act)
    if sequence:
        return net.apply_seq(w, *xs, carry, reset)
    return unroll(lambda c, *x: net.apply_params(w, *x[:-1], c, x[-1]), carry, *xs, reset)


@pytest.mark.parametrize("which", ["actor", "critic"])
def test_the_sequence_form_equals_the_step_loop(which):
    actor, critic = _nets()
    net, w = (actor, critic)[which == "critic"], _weights()[which]
    obs, act, reset = _inputs()
    act = None if which == "actor" else act
    b = obs.shape[1]
    # A nonzero starting state: five steps of another sequence.
    pre, pre_act, _ = _inputs(t=5, b=b, seed=1)
    _, c0 = _apply(net, w, pre, None if act is None else pre_act, net.initial_carry(b),
                   torch.zeros(5, b), False)
    y_step, c_step = _apply(net, w, obs, act, c0, reset, False)
    y_seq, c_seq = _apply(net, w, obs, act, c0, reset, True)
    assert _close(y_seq, y_step)
    for x, y in zip(tree_leaves(c_seq), tree_leaves(c_step), strict=True):
        assert (torch.equal(x, y) if not x.is_floating_point() else _close(x, y)), x.shape
    # A sequence form that lets the state through the resets reads far off.
    real = granite.GraniteHybridCore.sequence
    uncut = lambda self, x, carry, r: real(self, x, carry, torch.zeros_like(r))  # noqa: E731
    with pytest.MonkeyPatch.context() as m:
        m.setattr(granite.GraniteHybridCore, "sequence", uncut)
        y_bad, _ = _apply(net, w, obs, act, c0, reset, True)
    assert not _close(y_bad, y_step, 100 * TOL)


@pytest.mark.parametrize("which", ["actor", "critic"])
@pytest.mark.parametrize("sequence", [False, True], ids=["step", "sequence"])
def test_both_forms_equal_the_reference_entry(which, sequence):
    actor, critic = _nets()
    net, w = (actor, critic)[which == "critic"], _weights()[which]
    obs, act, reset = _inputs()
    ref, pr, carry, want = G.nets(CONF), Precision(), (), []
    for t in range(obs.shape[0]):
        if which == "actor":
            y, carry = ref.actor_step(w, obs[t], carry, reset[t], pr)
        else:
            y, carry = ref.critic_step(w, obs[t], act[t], carry, reset[t], pr)
        want.append(y)
    got, _ = _apply(net, w, obs, None if which == "actor" else act,
                    net.initial_carry(obs.shape[1]), reset, sequence)
    assert _close(got, torch.stack(want))


HP = L.HP(burnin=3, unroll=4, n_step=2, gamma=0.99, tau=5e-3, eta=0.9, actor_lr=1e-4,
          critic_lr=1e-3, grad_clip=40.0)


def _batch(b=6, seed=3):
    g = torch.Generator().manual_seed(seed)
    seq = HP.burnin + HP.unroll + HP.n_step
    reset = torch.zeros(b, seq)
    reset[0, 2] = reset[1, 5] = reset[2, 0] = reset[4, 7] = 1
    return {"obs": torch.randn(b, seq, OBS, generator=g),
            "action": torch.rand(b, seq, ACT, generator=g) * 2 - 1,
            "reward": torch.randn(b, seq, generator=g), "discount": torch.ones(b, seq),
            "reset": reset, "carry_actor": (), "carry_critic": ()}


def _reference(w, batch, weights, block):
    st = L.fresh_state(w["actor"], w["critic"], G.nets(CONF))
    return G.update(st, HP, batch, weights, Precision(), block=block)


def test_one_learner_step_equals_the_reference_update():
    actor, critic = _nets()
    agent = R2D2DPG(actor, critic, AgentConfig(
        burnin=HP.burnin, unroll=HP.unroll, n_step=HP.n_step, fused_burnin=False,
        replay_state="zero_start"))
    w = _weights()
    copy = lambda p: {k: v.clone() for k, v in p.items()}  # noqa: E731
    state = TrainState(copy(w["actor"]), copy(w["critic"]), copy(w["actor"]),
                       copy(w["critic"]), adam_init(w["actor"]), adam_init(w["critic"]), 0)
    batch = _batch()
    weights = torch.linspace(0.5, 1.0, 6)
    seq = SequenceBatch(**{k: batch[k] for k in ("obs", "action", "reward", "discount",
                                                 "reset")},
                        carries={"actor": (), "critic": ()})
    new, prio, metrics = agent.learner_step(state, seq, weights)
    st, ref_prio, losses, _ = _reference(w, batch, weights, block=4)
    assert abs(metrics["critic_loss"].item() - losses[0]) <= TOL * abs(losses[0])
    assert abs(metrics["actor_loss"].item() - losses[1]) <= TOL * abs(losses[1])
    assert _close(prio, ref_prio)
    # Adam's first moment is a tenth of the clipped gradient.
    for got, want in ((new.actor_opt_state.mu, st.adam_actor.mu),
                      (new.critic_opt_state.mu, st.adam_critic.mu)):
        assert set(got) == set(want)
        for k in want:
            assert _close(got[k], want[k], 1e-4), k
    # Adam's first step is ``lr g / (|g| + eps)``: an element whose gradient
    # is near ``eps`` moves by another share of ``lr`` on each side, so each
    # leaf's change (and its target's, a share ``tau`` of it) is compared
    # by its norm, as the benchmark's check compares it.
    for got, want, w0 in ((new.actor_params, st.actor, w["actor"]),
                          (new.critic_params, st.critic, w["critic"]),
                          (new.target_critic_params, st.target_critic, w["critic"])):
        for k in want:
            ref = (want[k] - w0[k]).norm()
            assert abs((got[k] - w0[k]).norm() - ref) <= TOL * ref, k


def test_the_blocked_reference_equals_the_whole_batch():
    """The loss's gradient summed over blocks of rows equals the whole
    batch's: rounding of a sum in another order (1e-6)."""
    w, batch, weights = _weights(), _batch(), torch.linspace(0.5, 1.0, 6)
    whole = _reference(w, batch, weights, block=6)
    blocks = _reference(w, batch, weights, block=2)
    for a, b in zip(whole[2], blocks[2]):
        assert abs(a - b) <= 1e-6 * abs(a)
    assert _close(blocks[1], whole[1], 1e-6)
    for net in ("actor", "critic"):
        for k, g in whole[3][net].items():
            assert _close(blocks[3][net][k], g, 1e-5), k


def _tiny_granite():
    """pendulum_tiny's recipe with the small hybrid core, zero-start replay."""
    return dataclasses.replace(
        PENDULUM_TINY, name="granite_tiny", use_lstm=False, hidden=64, core="granite_hybrid",
        granite=SPEC,
        agent=dataclasses.replace(PENDULUM_TINY.agent, fused_burnin=False,
                                  replay_state="zero_start"))


def _fill(cfg):
    t = cfg.build("cpu")
    state = t.init(Draws(0, torch.device("cpu")))
    for _ in range(t.window_fill_phases):
        state = t.collect_phase(state)
    for _ in range(t.replay_fill_phases):
        state = t.fill_phase(state)
    return t, state


def test_zero_start_replay_stores_no_carry():
    t, state = _fill(_tiny_granite())
    assert state.window.carries == {"actor": (), "critic": ()}
    assert state.arena.data.carries == {"actor": (), "critic": ()}
    assert state.arena.total_added > 0
    # The collection itself carries the core's state.
    assert len(state.actor_carry) == len(SPEC.layer_types)
    # Stored state, the default, keeps the LSTM's carries.
    _, lstm_state = _fill(PENDULUM_TINY)
    assert len(lstm_state.arena.data.carries["actor"]) == 2


def test_a_short_trainer_run_on_the_tensor_pendulum():
    t, state = _fill(_tiny_granite())
    for _ in range(2):
        state, metrics = t.train_phase(state)
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert state.train.step == 2 * t.config.learner_steps
    assert state.train.actor_params["core.layers.1.self_attn.q_proj.weight"].shape == (64, 64)


def test_the_core_spans_and_the_state_gauge_show_in_the_registry():
    from r2d2dpg_torch import obs
    from r2d2dpg_torch.obs import get_registry
    from r2d2dpg_torch.utils.profiling import SPAN_METRIC

    obs.enable_spans(True)
    try:
        t, state = _fill(_tiny_granite())
        t.train_phase(state)
    finally:
        obs.enable_spans(False)
    snap = get_registry().snapshot()
    spans = {s["labels"]["span"]: s["count"] for s in snap[SPAN_METRIC]["samples"]}
    for name in ("core/mamba", "core/attention", "core/mlp"):
        assert spans.get(name, 0) > 0, name
    gauge = {s["labels"]["net"]: s["value"]
             for s in snap["r2d2dpg_core_state_bytes"]["samples"]}
    assert gauge["actor"] == tree_nbytes(state.actor_carry)
    assert gauge["critic"] == tree_nbytes(state.critic_carry) > 0


def _refusals(cfg):
    from r2d2dpg_torch.fleet.actor import FleetActorTrainer
    from r2d2dpg_torch.fleet.ingest import FleetLearner
    from r2d2dpg_torch.fleet.sampler import SamplerLearner
    from r2d2dpg_torch.parallel import DPLearnerTrainer, HostSPMDTrainer
    from r2d2dpg_torch.serving import PolicyService
    from r2d2dpg_torch.training.pipeline import PipelineExecutor

    t = cfg.build("cpu")
    agent = t.agent
    return {
        "PolicyService": lambda: PolicyService(agent.actor, {}, device="cpu"),
        "PipelineExecutor": lambda: PipelineExecutor(t),
        "DPLearnerTrainer": lambda: DPLearnerTrainer(t.env, agent, cfg.trainer, None),
        "FleetLearner": lambda: FleetLearner(t, None),
        "SamplerLearner": lambda: SamplerLearner(t, None, num_shards=1),
        "the fleet's actor": lambda: FleetActorTrainer(
            t.env, agent, cfg.trainer, torch.device("cpu"), actor_index=0, num_actors=1),
        "HostSPMDTrainer": lambda: HostSPMDTrainer(t.env, agent, cfg.trainer, None),
    }


@pytest.mark.parametrize("where", ["PolicyService", "PipelineExecutor", "DPLearnerTrainer",
                                   "FleetLearner", "SamplerLearner", "the fleet's actor",
                                   "HostSPMDTrainer"])
def test_paths_that_cannot_run_the_core_refuse_it(where):
    with pytest.raises(ValueError, match=f"{where} cannot run core 'granite_hybrid'"):
        _refusals(_tiny_granite())[where]()


def test_a_learner_that_stacks_params_refuses_the_core():
    actor, critic = _nets()
    for cfg in (AgentConfig(), AgentConfig(fused_burnin=False, twin_critic=True)):
        with pytest.raises(ValueError, match="granite_hybrid"):
            R2D2DPG(actor, critic, cfg)
    with pytest.raises(ValueError, match="replay_state"):
        R2D2DPG(actor, critic, AgentConfig(fused_burnin=False, replay_state="latest"))


@pytest.mark.parametrize("name", sorted(set(CONFIGS) - {"walker_granite"}))
def test_every_other_config_keeps_its_carry_and_its_learner_path(name):
    """The LSTM configs' carry is the flat ``(c, h)`` of ``[B, H]`` float32
    (``()`` without an LSTM), their arena stores it, and their unrolls run
    the LSTM core's own forms (its sequence form in float32 and without an
    LSTM, the cell step by step in bf16): nothing of the hybrid core's path
    is taken."""
    cfg = get_config(name)
    obs_shape = (64, 64, 3) if cfg.pixels else (OBS,)
    env = types.SimpleNamespace(spec=EnvSpec(name="test", obs_shape=obs_shape, action_dim=ACT))
    agent = cfg.build_agent(env)
    assert cfg.core == "lstm" and agent.config.replay_state == "stored"
    for net in (agent.actor, agent.critic):
        carry = net.initial_carry(4, "cpu")
        want = [(4, cfg.hidden)] * 2 if cfg.use_lstm else []
        assert [tuple(x.shape) for x in carry] == want and isinstance(carry, tuple)
        assert all(x.dtype == torch.float32 for x in carry)
        assert net.stateful == cfg.use_lstm and net.ensemble_axis
        assert not isinstance(net.core, granite.GraniteHybridCore)
        route = (("sequence", "dense") if not cfg.use_lstm else
                 ("sequence", "float32") if cfg.compute_dtype == "float32" else
                 ("step", "mixed_precision"))
        assert net.core.unroll_route == route
        assert net.sequence_form == (route[0] == "sequence")


def test_walker_granite_holds_the_published_widths_of_the_first_period():
    cfg = get_config("walker_granite")
    assert cfg.granite == granite.GRANITE_4_0_H_MICRO
    assert cfg.layer_types == ("mamba",) * 5 + ("attention",) + ("mamba",) * 4
    assert (cfg.hidden, cfg.hidden_size, cfg.shared_intermediate_size) == (2048, 2048, 8192)
    assert (cfg.mamba_n_heads, cfg.mamba_d_head, cfg.mamba_d_state, cfg.mamba_d_conv) == (
        64, 64, 128, 4)
    assert (cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim) == (32, 8, 64)
    assert (cfg.residual_multiplier, cfg.attention_multiplier, cfg.embedding_multiplier,
            cfg.rms_norm_eps) == (0.22, 0.015625, 12, 1e-5)
    assert cfg.agent.replay_state == "zero_start" and not cfg.agent.fused_burnin
    walker = get_config("walker_r2d2")
    assert cfg.trainer == walker.trainer
    assert dataclasses.replace(cfg.agent, fused_burnin=True, replay_state="stored") == walker.agent
    assert isinstance(cfg, ExperimentConfig) and not hasattr(walker, "mamba_d_state")
