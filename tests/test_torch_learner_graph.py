"""The learner step's path choice off the card (``agents/graph.py``).

On CPU tensors ``R2D2DPG.learner_step`` runs the eager body: each call
counts ``r2d2dpg_learner_graph_total{event="eager",reason="cpu"}``, none
counts a capture or a replay, and the result is bitwise that of
``_learner_step_eager``.  A mesh-bound agent (``bind_mesh``, here over a
stub mesh whose mean is the identity) counts ``reason="mesh"``.  An
agent dropped by its caller frees its graph cache at once, with no
reference cycle for the collector to find later.  Adam's
bias reciprocals, the form the graph takes the corrections in, give
products within an ulp of the eager step's quotients on the CPU.  The
graphed path itself runs on a card only: ``tests/test_torch_cuda.py``.
"""

import gc
import types
import weakref

import numpy as np
import pytest
import torch

from r2d2dpg_torch.agents import AgentConfig, R2D2DPG
from r2d2dpg_torch.agents.ddpg import adam_bias_corrections, adam_bias_reciprocals
from r2d2dpg_torch.agents.graph import GRAPH_METRIC
from r2d2dpg_torch.models import ActorNet, CriticNet
from r2d2dpg_torch.obs import get_registry
from r2d2dpg_torch.replay import SequenceBatch
from r2d2dpg_torch.tree import tree_leaves, tree_with_leaves

B, OBS, ACT, HID = 8, 3, 2, 32


def _agent(use_lstm=True, **kw):
    cfg = AgentConfig(burnin=2 if use_lstm else 0, unroll=4, n_step=2, **kw)
    return R2D2DPG(ActorNet(OBS, ACT, hidden=HID, use_lstm=use_lstm),
                   CriticNet(OBS, ACT, hidden=HID, use_lstm=use_lstm), cfg)


def _inputs(agent, seed):
    rng = np.random.default_rng(seed)
    L, cfg = agent.config.seq_len, agent.config
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32))  # noqa: E731
    carry = lambda: (t(0.5 * rng.standard_normal((B, HID))),  # noqa: E731
                     t(0.5 * rng.standard_normal((B, HID))))
    lstm = agent.actor.use_lstm
    batch = SequenceBatch(
        obs=t(rng.standard_normal((B, L, OBS))),
        action=t(rng.uniform(-1, 1, (B, L, ACT))),
        reward=t(rng.standard_normal((B, L))),
        discount=t(rng.random((B, L)) > 0.05),
        reset=t(rng.random((B, L)) < 0.15),
        carries={"actor": carry() if lstm else (), "critic": carry() if lstm else ()},
    )
    w = t(rng.uniform(0.2, 1.0, B))
    normal = (t(rng.standard_normal((cfg.unroll + cfg.n_step, B, ACT)))
              if cfg.target_policy_sigma > 0 else None)
    return batch, w, normal


def _counts():
    inst = get_registry().get(GRAPH_METRIC)
    if inst is None:
        return {}
    return {key: cell.value for key, cell in inst._cells_snapshot()}


def _delta(before, after):
    return {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kind", ["lstm", "feedforward", "td3"])
def test_learner_step_on_the_cpu_is_the_eager_body_counted(kind):
    kw = dict(twin_critic=True, target_policy_sigma=0.2) if kind == "td3" else {}
    agent = _agent(use_lstm=kind != "feedforward", **kw)
    state = eager = agent.init(torch.Generator().manual_seed(1), "cpu")
    before = _counts()
    for step in range(3):
        batch, w, normal = _inputs(agent, step)
        state, prios, metrics = agent.learner_step(state, batch, w, normal)
        eager, e_prios, e_metrics = agent._learner_step_eager(eager, batch, w, normal)
        _equal((state, prios, metrics), (eager, e_prios, e_metrics))
        assert state.step == eager.step == step + 1
        assert state.actor_opt_state.count == state.critic_opt_state.count == step + 1
    assert _delta(before, _counts()) == {("eager", "cpu"): 3.0}


def test_mesh_bound_agent_steps_eagerly_for_the_mesh():
    agent = _agent(axis_name="dp")
    calls = []
    mesh = types.SimpleNamespace(pmean_=lambda flat: calls.append(flat.numel()))
    bound = agent.bind_mesh(mesh)
    state = agent.init(torch.Generator().manual_seed(2), "cpu")
    batch, w, normal = _inputs(agent, 0)
    before = _counts()
    got = bound.learner_step(state, batch, w, normal)
    _equal(got, bound._learner_step_eager(state, batch, w, normal))
    assert _delta(before, _counts()) == {("eager", "mesh"): 1.0}
    assert len(calls) == 4  # critic and actor gradients, in each of the two steps


@pytest.mark.parametrize("count", [1, 2, 7, 100, 12345])
def test_adam_bias_reciprocals_are_within_an_ulp_of_the_division(count):
    """The graph multiplies by the float32 reciprocal of each correction
    (what CUDA does for a division by a host scalar); on the CPU, which
    divides, a product lies within one ulp of the quotient."""
    x = torch.from_numpy(np.random.default_rng(count).standard_normal(4096)
                         .astype(np.float32))
    for bc, r in zip(adam_bias_corrections(count), adam_bias_reciprocals(count)):
        assert r == float(np.float32(1.0) / np.float32(bc))
        ulps = (x * r).view(torch.int32) - (x / bc).view(torch.int32)
        assert int(ulps.abs().max()) <= 1


def test_tree_with_leaves_rebuilds_a_train_state():
    agent = _agent()
    state = agent.init(torch.Generator().manual_seed(3), "cpu")
    leaves = tree_leaves(state)
    doubled = tree_with_leaves(state, [2 * x for x in leaves])
    assert doubled.step == state.step
    assert doubled.actor_opt_state.count == state.actor_opt_state.count
    for x, y in zip(tree_leaves(doubled), leaves):
        assert torch.equal(x, 2 * y)
    with pytest.raises(ValueError, match="more leaves"):
        tree_with_leaves(state, leaves + [leaves[0]])


def test_a_dropped_agent_frees_its_graph_cache_at_once():
    """No cycle holds the cache: a graph destroyed by the collector could
    land inside another capture, where CUDA forbids it."""
    agent = _agent()
    agent.learner_step(agent.init(torch.Generator().manual_seed(4), "cpu"),
                       *_inputs(agent, 0))
    cache = weakref.ref(agent._graphs)
    collecting = gc.isenabled()
    gc.disable()
    try:
        del agent
        assert cache() is None
    finally:
        if collecting:
            gc.enable()
