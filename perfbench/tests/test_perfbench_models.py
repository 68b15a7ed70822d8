"""Model entries found by name: the two configurations resolve to the
``lstm`` entry, whose inputs, reference run and FLOP counts are bitwise
those of the direct calls the harness made before entries; a configuration
of a new architecture (a feed-forward core, ``tests/feedforward.py``) runs
the learn loop from new files alone; the program's config must have every
key of ``nets``."""

import dataclasses
import json

import pytest
import torch

from perfbench import flops, harness, inputs, models
from perfbench.drivers import program
from perfbench.models import lstm
from perfbench.reference import learner as L
from perfbench.reference import runs
from perfbench.reference.nets import param_shapes
from perfbench.tests import tiny

CONFIGS = ["walker_r2d2", "cheetah_pixels"]
LEARN = json.loads((harness.HERE / "traffic" / "learn.json").read_text())


def _conf(name):
    return json.loads((harness.HERE / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", CONFIGS)
def test_each_configuration_resolves_to_the_lstm_entry(name):
    assert "core" not in _conf(name)["nets"]
    assert models.entry(_conf(name)) is lstm


def _direct_arena(conf, seed, cap):
    """The arena as the harness drew it before entries: ``(c, h)`` of width
    ``hidden`` for each net, ``c ~ N(0, 0.25)`` then ``h ~ U(-0.5, 0.5)``."""
    env, a, h = conf["env"], conf["agent"], conf["nets"]["hidden"]
    seq = a["burnin"] + a["unroll"] + a["n_step"]
    z = lambda *s, dtype=torch.float32: torch.zeros(s, dtype=dtype)  # noqa: E731
    arena = {"obs": z(cap, seq, *env["obs_shape"], dtype=getattr(torch, env["obs_dtype"])),
             "action": z(cap, seq, env["action_dim"]), "reward": z(cap, seq),
             "discount": z(cap, seq), "reset": z(cap, seq),
             "carry_actor": (z(cap, h), z(cap, h)), "carry_critic": (z(cap, h), z(cap, h))}
    priority = torch.zeros(cap)
    g = inputs.generator(seed, "arena", "cpu")
    obs = arena["obs"]
    obs.random_(0, 256, generator=g) if obs.dtype == torch.uint8 else obs.normal_(generator=g)
    arena["action"].uniform_(-1.0, 1.0, generator=g)
    arena["reward"].normal_(generator=g)
    arena["discount"].fill_(1.0)
    crosses = torch.rand(cap, generator=g) < seq / env["episode_length"]
    pos = torch.randint(0, seq, (cap,), generator=g)
    arena["reset"][torch.arange(cap), pos] = crosses.float()
    for key in ("carry_actor", "carry_critic"):
        c, hh = arena[key]
        c.normal_(0.0, 0.5, generator=g)
        hh.uniform_(-0.5, 0.5, generator=g)
    priority.uniform_(*LEARN["priority_range"], generator=g)
    return arena, priority


@pytest.mark.parametrize("name", CONFIGS)
def test_the_lstm_entry_equals_the_direct_calls_bitwise(name):
    conf, seed = _conf(name), 2**31 + 9
    env, a, t = conf["env"], conf["agent"], conf["trainer"]
    shapes = param_shapes(env["obs_shape"], env["action_dim"], conf["nets"]["hidden"],
                          conf["nets"]["pixels"])
    assert lstm.shapes(conf) == shapes
    assert lstm.learn_unit(conf) == flops.learner_step(
        flops.shapes_of(conf), t["batch_size"], a["burnin"], a["unroll"], a["n_step"])
    assert lstm.train_unit(conf) == flops.train_phase(flops.shapes_of(conf), a, t)

    # At the configuration's widths, on an arena of a batch's slots.
    cap = t["batch_size"]
    small = dict(conf, trainer=dict(t, capacity=cap))
    carries = lstm.carries(small)
    got = inputs.alloc_arena(cap, lstm.seq_len(small), env["obs_shape"], env["obs_dtype"],
                             env["action_dim"], carries, "cpu")
    got_prio = torch.zeros(cap)
    inputs.fill_arena(got, got_prio, seed, env["episode_length"], LEARN["priority_range"],
                      carries)
    want, want_prio = _direct_arena(small, seed, cap)
    assert torch.equal(got_prio, want_prio)
    for k in want:
        for x, y in zip(*((got[k], want[k]) if isinstance(want[k], tuple)
                          else ((got[k],), (want[k],)))):
            assert torch.equal(x, y), k

    traffic = dict(LEARN, check_units=1)
    ref = lstm.learn(small, traffic, seed, "cpu", None)
    w0 = inputs.make_weights(shapes, seed, "cpu")
    st = L.fresh_state(w0["actor"], w0["critic"])
    u = runs.learn_draws(small, seed, "cpu", 1)
    st, losses, _, _ = L.follow(st, runs.hyper(small), want, want_prio, u, None, cap,
                                t["priority_alpha"], t["beta0"], t["beta_steps"],
                                L.Precision("float32"))
    assert ref["losses"] == losses
    assert torch.equal(ref["priority"], want_prio)
    for k, v in st.actor.items():
        assert ref["change"]["actor"][k] == (v - w0["actor"][k]).double().norm().item()


def _feed_forward(monkeypatch):
    """The test-only entry where the harness looks for entries, and the
    program's config of the same numbers (pendulum_tiny's recipe, no LSTM)."""
    from r2d2dpg_torch import configs

    monkeypatch.setattr(models, "__path__", [*models.__path__, str(harness.HERE / "tests")])
    monkeypatch.delitem(__import__("sys").modules, "perfbench.models.feedforward",
                        raising=False)
    cfg = dataclasses.replace(configs.PENDULUM_TINY, name="perfbench_tiny_ff", use_lstm=False)
    monkeypatch.setitem(configs.CONFIGS, cfg.name, cfg)
    conf = tiny.config_file(cfg.name)
    conf["nets"]["core"] = "feedforward"
    return conf


def test_a_feed_forward_core_runs_the_learn_loop_from_new_files(monkeypatch):
    conf = _feed_forward(monkeypatch)
    assert models.entry(conf).carries(conf) == {"actor": [], "critic": []}
    _, window, out = tiny.run(tiny.cell("learn", conf), seed=2**31 + 21)
    assert out["correct"], out["checks"]
    assert window.attempted > 0 and window.failed == 0
    assert window.checks["index_misses"] == 0


def test_the_program_must_have_every_key_of_nets():
    conf = tiny.config_file("pendulum_tiny")
    program.experiment(conf, 1)
    conf["nets"]["memory_len"] = 512
    with pytest.raises(ValueError, match="nets.memory_len"):
        program.experiment(conf, 1)
    conf["nets"].pop("memory_len")
    conf["nets"]["hidden"] += 1
    with pytest.raises(ValueError, match="differs"):
        program.experiment(conf, 1)
