"""The plain reference agrees with ``r2d2dpg_torch`` at small widths on the
CPU: one learner update on the same batch, and each cell's driver (a full
arena's learner steps, the train loop's set-up and first train phases on
the stand-in, a served rollout) with its own comparison."""

import pytest
import torch

from perfbench import inputs
from perfbench.drivers import program
from perfbench.models import lstm
from perfbench.reference import learner as L
from perfbench.reference.nets import Precision, param_shapes
from perfbench.tests import tiny


def test_one_update_matches_the_programs_learner_step():
    from r2d2dpg_torch.configs import get_config
    from r2d2dpg_torch.envs.core import EnvSpec

    import types

    cfg = get_config("pendulum_tiny")
    agent = cfg.build_agent(types.SimpleNamespace(spec=EnvSpec("t", (24,), 6)))
    a = cfg.agent
    seq, b, h = a.seq_len, 6, cfg.hidden
    w = inputs.make_weights(param_shapes((24,), 6, h, False), 7, "cpu")
    carries = lstm.carries({"nets": {"hidden": h}})
    leaves = inputs.alloc_arena(b, seq, (24,), "float32", 6, carries, "cpu")
    inputs.fill_arena(leaves, torch.zeros(b), 7, 5, (0.5, 1.5), carries)
    weights = torch.rand(b)
    new, prio, metrics = agent.learner_step(program.train_state(agent, w),
                                            program.sequence_batch(leaves), weights)
    hp = L.HP(a.burnin, a.unroll, a.n_step, a.gamma, a.tau, a.eta, a.actor_lr, a.critic_lr,
              a.grad_clip)
    ref, ref_prio, losses, _ = L.update(L.fresh_state(w["actor"], w["critic"]), hp, leaves,
                                        weights, Precision())
    torch.testing.assert_close(prio, ref_prio, rtol=1e-5, atol=1e-6)
    assert metrics["critic_loss"].item() == pytest.approx(losses[0], rel=1e-5)
    assert metrics["actor_loss"].item() == pytest.approx(losses[1], rel=1e-5)
    for mine, theirs in ((new.actor_params, ref.actor), (new.critic_params, ref.critic),
                         (new.target_critic_params, ref.target_critic)):
        for k in theirs:
            torch.testing.assert_close(mine[k], theirs[k], rtol=1e-5, atol=1e-6)


def _pixels(monkeypatch):
    from r2d2dpg_torch import configs

    cfg = tiny.tiny_pixels()
    monkeypatch.setitem(configs.CONFIGS, cfg.name, cfg)
    return tiny.config_file(cfg.name, obs_shape=(36, 36, 3), obs_dtype="uint8",
                            episode_length=9)


@pytest.mark.parametrize("frames", [False, True], ids=["flat", "frames"])
def test_learn_cell_is_correct_at_toy_size(monkeypatch, frames):
    conf = _pixels(monkeypatch) if frames else tiny.config_file("pendulum_tiny")
    _, window, out = tiny.run(tiny.cell("learn", conf), seed=2**31 + 11)
    assert out["correct"], out["checks"]
    assert window.attempted > 0 and window.failed == 0
    assert window.checks["index_misses"] == 0


def test_train_cell_is_correct_at_toy_size():
    _, window, out = tiny.run(tiny.cell("train", tiny.config_file("pendulum_tiny")), seed=5)
    assert out["correct"], out["checks"]
    assert window.attempted > 0 and window.failed == 0
    assert window.checks["seq_gap"] < 1e-5


def test_serve_cell_is_correct_at_toy_size():
    c = tiny.cell("serve", tiny.config_file("pendulum_tiny"), rate_per_s=600, warmup_s=0.2)
    _, window, out = tiny.run(c, seed=9, seconds=0.4)
    assert out["correct"], out["checks"]
    assert window.attempted > 100 and window.failed == 0


def test_the_check_follows_the_programs_indices_within_rounding():
    """A draw within rounding of a slot boundary bears out either slot; a
    slot the reference's CDF does not bear out, or an empty one, is a miss."""
    prio = torch.tensor([1.0, 1.0, 0.0, 2.0])  # CDF 1, 2, 2, 4
    u = torch.tensor([0.1, 0.5 - 1e-7, 0.9])
    idx, _, cdf, total, scaled = L.sample(prio, u, alpha=1.0)
    assert idx.tolist() == [0, 1, 3]
    assert L.index_misses(idx, u, cdf, total, scaled) == 0
    assert L.index_misses(torch.tensor([0, 3, 3]), u, cdf, total, scaled) == 0
    assert L.index_misses(torch.tensor([1, 1, 3]), u, cdf, total, scaled) == 1
    assert L.index_misses(torch.tensor([0, 2, 3]), u, cdf, total, scaled) == 1
