"""The ``granite_hybrid`` model entry: its ``learn_unit`` equals what
``FlopCounterMode`` counts of the reference's update at two small shape
sets, and the learn loop on a small hybrid config runs and is judged from
the entry's files alone, and reads a reset left uncut as not correct."""

import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import inputs, models
from perfbench.models import granite_hybrid as G
from perfbench.reference import learner as L
from perfbench.reference.nets import Precision
from perfbench.tests import tiny

SHAPES = {
    "d32": dict(hidden_size=32, shared_intermediate_size=48, mamba_n_heads=4, mamba_d_head=16,
                mamba_d_state=8, num_attention_heads=4, num_key_value_heads=2,
                layer_types=["mamba", "attention", "mamba"], obs=5, act=3, b=5),
    "d48": dict(hidden_size=48, shared_intermediate_size=64, mamba_n_heads=6, mamba_d_head=16,
                mamba_d_state=4, num_attention_heads=6, num_key_value_heads=3,
                layer_types=["attention", "mamba"], obs=7, act=2, b=3),
}
HP = L.HP(burnin=3, unroll=4, n_step=2, gamma=0.99, tau=5e-3, eta=0.9, actor_lr=1e-4,
          critic_lr=1e-3, grad_clip=40.0)


def _conf(s):
    s = dict(s)
    obs, act, b = s.pop("obs"), s.pop("act"), s.pop("b")
    return {"env": {"obs_shape": [obs], "action_dim": act}, **s,
            "num_hidden_layers": len(s["layer_types"]), "mamba_d_conv": 4,
            "residual_multiplier": 0.22, "attention_multiplier": 0.25,
            "embedding_multiplier": 12, "rms_norm_eps": 1e-5,
            "agent": {"burnin": HP.burnin, "unroll": HP.unroll, "n_step": HP.n_step},
            "trainer": {"batch_size": b}}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_learn_unit_equals_the_counted_reference_update(name):
    """Autograd also makes three products the count leaves out: the
    gradient of the ``mix`` layer's action block in the critic update and
    of its torso block in the actor update (as for the LSTM), and the
    attention's gradients of the keys and values burn-in handed over."""
    conf = _conf(SHAPES[name])
    env, b = conf["env"], conf["trainer"]["batch_size"]
    seq, d, a = HP.burnin + HP.unroll + HP.n_step, conf["hidden_size"], env["action_dim"]
    g = torch.Generator().manual_seed(0)
    reset = torch.zeros(b, seq)
    reset[0, 5] = 1
    batch = {"obs": torch.randn(b, seq, *env["obs_shape"], generator=g),
             "action": torch.rand(b, seq, a, generator=g) * 2 - 1,
             "reward": torch.randn(b, seq, generator=g), "discount": torch.ones(b, seq),
             "reset": reset, "carry_actor": (), "carry_critic": ()}
    w = inputs.make_weights(G.shapes(conf), 1, "cpu")
    st = L.fresh_state(w["actor"], w["critic"], G.nets(conf))
    with FlopCounterMode(display=False) as counter:
        G.update(st, HP, batch, torch.ones(b), Precision(), block=2)
    n_attn = conf["layer_types"].count("attention")
    unneeded = b * HP.unroll * (2 * a * d + 2 * d * d + 3 * n_attn * 4 * d * HP.burnin)
    assert counter.get_total_flops() == G.learn_unit(conf) + unneeded


def _small(monkeypatch):
    """A small hybrid config of the port's (pendulum_tiny's recipe) and its
    configuration file, as a new configuration would come."""
    from r2d2dpg_torch import configs
    from r2d2dpg_torch.models import GraniteSpec

    spec = GraniteSpec(hidden_size=32, shared_intermediate_size=48,
                       layer_types=("mamba", "attention"), mamba_n_heads=4, mamba_d_head=16,
                       mamba_d_state=8, num_attention_heads=4, num_key_value_heads=2)
    cfg = dataclasses.replace(
        configs.PENDULUM_TINY, name="perfbench_tiny_granite", use_lstm=False, hidden=32,
        core="granite_hybrid", granite=spec,
        agent=dataclasses.replace(configs.PENDULUM_TINY.agent, fused_burnin=False,
                                  replay_state="zero_start"))
    monkeypatch.setitem(configs.CONFIGS, cfg.name, cfg)
    conf = tiny.config_file(cfg.name)
    conf["nets"].update(core="granite_hybrid", mamba_d_state=8)
    conf["agent"].update(fused_burnin=False, replay_state="zero_start")
    conf.update({f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)},
                layer_types=list(spec.layer_types), num_hidden_layers=2)
    return conf


def test_a_small_hybrid_config_runs_the_learn_loop_and_reads_correct(monkeypatch):
    conf = _small(monkeypatch)
    assert models.entry(conf) is G
    _, window, out = tiny.run(tiny.cell("learn", conf), seed=2**31 + 33)
    assert out["correct"], out["checks"]
    assert window.attempted > 0 and window.failed == 0


@pytest.mark.parametrize("mixer", ["Mamba2Mixer", "GQAttention"])
def test_a_reset_left_uncut_reads_not_correct(monkeypatch, mixer):
    """The planted faults: the SSM's state and the convolution's taps, or
    the attention's mask, let through a reset inside the sequence form."""
    from r2d2dpg_torch.models import granite

    conf = _small(monkeypatch)
    cls = getattr(granite, mixer)
    real = cls._sequence
    monkeypatch.setattr(cls, "_sequence",
                        lambda self, x, carry, seg: real(self, x, carry, torch.zeros_like(seg)))
    _, _, out = tiny.run(tiny.cell("learn", conf), seed=2**31 + 33)
    assert not out["correct"], (mixer, out["checks"])
