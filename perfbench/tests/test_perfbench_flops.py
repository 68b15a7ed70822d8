"""The analytic FLOP count (``perfbench/flops.py``) equals what
``FlopCounterMode`` counts of matmuls and convolutions over the plain
reference's work, at two small shape sets (flat observations and frames)."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import flops, inputs
from perfbench.reference import learner as L
from perfbench.reference.nets import Precision, actor_step, critic_step, param_shapes

SHAPES = {
    "flat": flops.Shapes((7,), 3, 16, False),
    "frames": flops.Shapes((36, 36, 3), 2, 8, True),
}
HP = L.HP(burnin=3, unroll=4, n_step=2, gamma=0.99, tau=5e-3, eta=0.9, actor_lr=1e-4,
          critic_lr=1e-3, grad_clip=40.0)


def _batch(s, b, seq):
    g = torch.Generator().manual_seed(0)
    if s.pixels:
        obs = torch.randint(0, 256, (b, seq, *s.obs_shape), generator=g, dtype=torch.uint8)
    else:
        obs = torch.randn(b, seq, *s.obs_shape, generator=g)
    reset = torch.zeros(b, seq)
    reset[0, 5] = 1
    carry = lambda: (torch.randn(b, s.hidden, generator=g), torch.randn(b, s.hidden, generator=g))  # noqa: E731
    return {"obs": obs, "action": torch.rand(b, seq, s.action_dim, generator=g) * 2 - 1,
            "reward": torch.randn(b, seq, generator=g), "discount": torch.ones(b, seq),
            "reset": reset, "carry_actor": carry(), "carry_critic": carry()}


def _state(s):
    w = inputs.make_weights(param_shapes(s.obs_shape, s.action_dim, s.hidden, s.pixels), 1, "cpu")
    return L.fresh_state(w["actor"], w["critic"])


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_learner_step_count_equals_the_counted_reference_step(name):
    """The reference's ``mix`` layer takes ``[torso, action]`` as one input,
    so autograd also makes the gradient of the block that needs none: the
    action's in the critic update, the torso's in the actor update.  Those
    two products are the only difference."""
    s, b = SHAPES[name], 5
    seq = HP.burnin + HP.unroll + HP.n_step
    batch, st = _batch(s, b, seq), _state(s)
    counted = _count(lambda: L.update(st, HP, batch, torch.ones(b), Precision()))
    unneeded = b * HP.unroll * (2 * s.action_dim * s.hidden + 2 * s.hidden * s.hidden)
    assert counted == flops.learner_step(s, b, HP.burnin, HP.unroll, HP.n_step) + unneeded


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_entry_priority_and_collection_step_counts(name):
    s, b = SHAPES[name], 4
    seq = HP.burnin + HP.unroll + HP.n_step
    batch, st = _batch(s, b, seq), _state(s)
    counted = _count(lambda: L.initial_priority(st, HP, batch, Precision()))
    assert counted == flops.initial_priority(s, b, HP.burnin, HP.unroll, HP.n_step)
    obs, carry = batch["obs"][:, 0], batch["carry_actor"]
    reset = batch["reset"][:, 0]
    with torch.no_grad():
        counted = _count(lambda: actor_step(st.actor, obs, carry, reset, Precision()))
        act = batch["action"][:, 0]
        counted += _count(lambda: critic_step(st.critic, obs, act, carry, reset, Precision()))
    assert counted == flops.collect_step(s, b)


def test_train_phase_adds_its_parts():
    s = SHAPES["flat"]
    agent = {"burnin": 3, "unroll": 4, "n_step": 2}
    trainer = {"num_envs": 6, "stride": 5, "learner_steps": 2, "batch_size": 4}
    want = (5 * flops.collect_step(s, 6) + flops.initial_priority(s, 6, 3, 4, 2)
            + 2 * flops.learner_step(s, 4, 3, 4, 2))
    assert flops.train_phase(s, agent, trainer) == want
