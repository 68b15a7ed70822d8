"""The benchmark's inputs and traffic come from the seed alone: one seed
gives one stream, two seeds give two."""

import numpy as np
import pytest
import torch

from perfbench import inputs
from perfbench.models import lstm
from perfbench.traffic.client import Client, nearest_rank
from perfbench.traffic.standin import StandIn

SEEDS = (3, 2**31 + 17)


def _rollout(seed, steps=30, lanes=4):
    env = StandIn(seed)
    obs = [env.reset(np.arange(lanes) + seed)]
    rng = np.random.default_rng(0)
    for _ in range(steps):
        obs.append(env.step(rng.uniform(-1, 1, (lanes, 6)))[0])
    return np.stack(obs)


class _Echo:
    """A stand-in service that answers at once with ``tanh`` of the obs."""

    class _Req:
        def __init__(self, obs, t):
            self.done, self.code, self.enqueued_at, self.latency_s = True, "ok", t, 0.0
            self.action = np.tanh(obs[:6])

    def act_async(self, session, obs, reset=False):
        return self._Req(obs, 0.0)

    def end_session(self, session):
        return True


def _served(seed):
    client = Client(_Echo(), StandIn(seed, episode_length=5), [seed, seed + 1, seed + 2],
                    rate_per_s=3000)
    rec = client.recorder(0.05)
    client.run(0.05, record=rec)
    assert rec["count"].min() >= 10
    return [rec["obs"][lane, :10] for lane in range(3)]


@pytest.mark.parametrize("seed", SEEDS)
def test_one_seed_gives_one_env_stream(seed):
    np.testing.assert_array_equal(_rollout(seed), _rollout(seed))


def test_two_seeds_give_two_env_streams():
    assert not np.allclose(_rollout(SEEDS[0]), _rollout(SEEDS[1]))


def test_the_serving_client_replays_its_sessions():
    a, b, c = _served(SEEDS[0]), _served(SEEDS[0]), _served(SEEDS[1])
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.allclose(a[0], c[0])


def test_sessions_restart_with_reset_each_episode():
    client = Client(_Echo(), StandIn(1, episode_length=4), [1, 2], rate_per_s=2000)
    rec = client.recorder(0.02)
    client.run(0.02, record=rec)
    assert rec["reset"][0, :9].tolist() == [1, 0, 0, 0, 1, 0, 0, 0, 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_weights_arena_and_draws_repeat_per_seed(seed):
    shapes = {"actor": {"w": (4, 3), "b": (4,)}, "critic": {"head.weight": (1, 4)}}
    w1, w2 = inputs.make_weights(shapes, seed, "cpu"), inputs.make_weights(shapes, seed, "cpu")
    other = inputs.make_weights(shapes, seed + 1, "cpu")
    assert torch.equal(w1["actor"]["w"], w2["actor"]["w"])
    assert not torch.equal(w1["actor"]["w"], other["actor"]["w"])
    assert float(w1["critic"]["head.weight"].abs().max()) <= 3e-3

    def arena(s):
        carries = lstm.carries({"nets": {"hidden": 4}})
        leaves = inputs.alloc_arena(50, 9, (5,), "float32", 2, carries, "cpu")
        prio = torch.zeros(50)
        inputs.fill_arena(leaves, prio, s, 18, (0.5, 1.5), carries)
        return leaves, prio

    (a, pa), (b, pb), (c, _) = arena(seed), arena(seed), arena(seed + 1)
    assert torch.equal(a["obs"], b["obs"]) and torch.equal(pa, pb)
    assert not torch.equal(a["obs"], c["obs"])
    assert float(pa.min()) >= 0.5 and float(pa.max()) <= 1.5
    assert set(a["reset"].sum(1).tolist()) <= {0.0, 1.0} and a["reset"].sum() > 0
    d1, d2 = inputs.Draws(seed, "x", "cpu"), inputs.Draws(seed, "x", "cpu")
    assert torch.equal(d1.uniform((6,)), d2.uniform((6,)))


def test_nearest_rank_percentile():
    assert nearest_rank([], 95) == 0.0
    assert nearest_rank(list(range(1, 101)), 95) == 95
    assert nearest_rank([3.0, 1.0, 2.0], 50) == 2.0
