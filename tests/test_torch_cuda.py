"""The port's CUDA kernels on a card, against their plain versions; the
serving slabs and the service's bitwise contract on the card.

Marked ``cuda``; each test skips without a card.  This file imports no JAX,
so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Every comparison is bitwise: the scatter only copies values.  The batch
sizes cover one lane, a ragged single warp, whole warps, a ragged last warp,
one block of 1,024 threads, and several blocks past it (with a ragged last
block); the arena's write-back runs at the cheetah_pixels shapes
(capacity 8,000, B 32).  The session slabs' gather and write-back on the
card equal the CPU's (bitwise), and a ``PolicyService`` on the card at
walker_r2d2's actor width serves each of 8 interleaved sessions bitwise
what the session alone in row 0 of a 32-row step gets, and within 1e-5
absolute of the plain one-row rollout (``policy_step_fn``, no row-wise
form; actions are about 0.1, and the two differed by 2.9e-9 on an H100).
The scatter launched on a side stream equals the plain version, and the
pipelined executor at pendulum_tiny on the card keeps its schedule's counts
with one scatter launch per learner step.
"""

import numpy as np
import pytest
import torch

from r2d2dpg_torch.kernels import PRIORITY_SCATTER
from r2d2dpg_torch.models import ActorNet, policy_step_fn
from r2d2dpg_torch.ops.priority import PRIORITY_EPS
from r2d2dpg_torch.ops.scatter import priority_scatter, priority_scatter_plain
from r2d2dpg_torch.replay import ReplayArena, SequenceBatch
from r2d2dpg_torch.serving import PolicyService, SessionStore, gather_carries, scatter_carries
from r2d2dpg_torch.serving.service import expand_rows, rowwise_policy_step_fn
from r2d2dpg_torch.testing import SCATTER_PATTERNS, scatter_case

BATCHES = (1, 31, 32, 33, 64, 65, 256, 1024, 1025, 4096, 8192)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _plain(prio, idx, vals):
    return priority_scatter_plain(
        torch.from_numpy(prio.copy()), torch.from_numpy(idx), torch.from_numpy(vals)
    ).numpy()


def _kernel(prio, idx, vals, dev):
    got = torch.from_numpy(prio).to(dev)
    before = PRIORITY_SCATTER.launches
    priority_scatter(got, torch.from_numpy(idx).to(dev), torch.from_numpy(vals).to(dev))
    torch.cuda.synchronize()
    assert PRIORITY_SCATTER.launches == before + 1
    return got.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("capacity,b", [(100_000, 64), (50_000, 256), (300, 64)])
def test_priority_scatter_kernel_matches_plain_exactly(capacity, b):
    dev = _card()
    prio, idx, vals = scatter_case("mixed", capacity, b, seed=b)
    np.testing.assert_array_equal(_kernel(prio, idx, vals, dev), _plain(prio, idx, vals))


@pytest.mark.cuda
@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("pattern", SCATTER_PATTERNS)
def test_priority_scatter_patterns_match_plain_exactly(pattern, b):
    dev = _card()
    prio, idx, vals = scatter_case(pattern, 100_000, b, seed=b)
    np.testing.assert_array_equal(_kernel(prio, idx, vals, dev), _plain(prio, idx, vals))


@pytest.mark.cuda
def test_priority_scatter_replays_in_a_cuda_graph():
    dev = _card()
    capacity, b = 100_000, 64
    prio, idx, vals = (torch.from_numpy(a).to(dev)
                       for a in scatter_case("mixed", capacity, b, seed=1))
    priority_scatter(prio.clone(), idx, vals)  # build and load before capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        priority_scatter(prio, idx, vals)
    for seed, pattern in enumerate(SCATTER_PATTERNS, start=2):
        case = scatter_case(pattern, capacity, b, seed=seed)
        for buf, a in zip((prio, idx, vals), case):
            buf.copy_(torch.from_numpy(a))
        graph.replay()
        torch.cuda.synchronize()
        np.testing.assert_array_equal(prio.cpu().numpy(), _plain(*case))


@pytest.mark.cuda
def test_update_priorities_at_the_cheetah_shapes_matches_plain_exactly():
    """``ReplayArena.update_priorities`` on a capacity-8,000 arena at B = 32,
    with a forced duplicate and priorities below ``PRIORITY_EPS``."""
    dev = _card()
    capacity, b = 8_000, 32
    g = torch.Generator(device=dev).manual_seed(5)
    z = torch.zeros(capacity, 1, device=dev)
    example = SequenceBatch(obs=z, action=z, reward=z, discount=z, reset=z, carries={})
    arena = ReplayArena(capacity, prioritized=True)
    state = arena.init_state(example)
    arena.add(state, example, torch.rand(capacity, generator=g, device=dev) + 0.5)
    idx = arena.sample(state, b, generator=g).indices
    idx[-1] = idx[0]
    prios = torch.rand(b, generator=g, device=dev) * 2 - 0.5
    want = priority_scatter_plain(
        state.priority.cpu(), idx.cpu(), prios.clamp_min(PRIORITY_EPS).cpu()
    )
    before = PRIORITY_SCATTER.launches
    arena.update_priorities(state, idx, prios)
    torch.cuda.synchronize()
    assert PRIORITY_SCATTER.launches == before + 1
    np.testing.assert_array_equal(state.priority.cpu().numpy(), want.numpy())


@pytest.mark.cuda
def test_session_slabs_gather_and_write_back_on_the_card():
    dev = _card()
    actor = ActorNet((24,), 6, hidden=256)
    store = SessionStore(1024, actor.initial_carry)
    g = torch.Generator().manual_seed(0)
    slots = torch.cat([torch.randperm(1024, generator=g)[:20], torch.full((12,), 1024)])
    new = tuple(torch.randn(32, 256, generator=g) for _ in range(2))
    out = {}
    for d in ("cpu", dev):
        slabs = store.init_slabs(d)
        for buf in slabs.carries:
            buf.copy_(torch.arange(buf.numel(), dtype=torch.float32).view_as(buf))
        got = gather_carries(slabs, slots.to(d))
        scatter_carries(slabs, slots.to(d), tuple(x.to(d) for x in new))
        out[str(d)] = ([x.cpu() for x in got], [x[:1024].cpu() for x in slabs.carries])
    for a, b in zip(out["cpu"][0] + out["cpu"][1], out[str(dev)][0] + out[str(dev)][1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_service_is_bitwise_across_buckets_on_the_card():
    dev = _card()
    actor = ActorNet((24,), 6, hidden=256)
    params = actor.init_params(torch.Generator().manual_seed(1), dev)
    rng = np.random.default_rng(0)
    obs = {f"s{i}": rng.standard_normal((6, 24)).astype(np.float32) for i in range(8)}
    got = {s: [] for s in obs}
    with PolicyService(actor, params, obs_shape=(24,), max_sessions=64,
                       flush_ms=1.0, device=dev) as svc:
        for t in range(6):
            # 3, 4, ..., 8 sessions a round, joining late.
            live = [s for i, s in enumerate(obs) if i <= t + 2]
            pending = [(s, svc.act_async(s, obs[s][len(got[s])],
                                         reset=not got[s])) for s in live]
            for s, req in pending:
                assert req.wait(60.0) and req.code == "ok", req.code
                got[s].append(req.action)
    step = rowwise_policy_step_fn(actor)
    plain = policy_step_fn(actor)
    rows = expand_rows(params, 32)
    for s in obs:
        carry = actor.initial_carry(32, dev)
        carry1 = actor.initial_carry(1, dev)
        for t, action in enumerate(got[s]):
            o = torch.zeros(32, 24, device=dev)
            o[0] = torch.from_numpy(obs[s][t]).to(dev)
            reset = torch.ones(32, device=dev)
            reset[0] = 1.0 if t == 0 else 0.0
            want, carry = step(rows, o, carry, reset)
            np.testing.assert_array_equal(action, want[0].cpu().numpy())
            a1, carry1 = plain(params, o[:1], carry1, reset[:1])
            np.testing.assert_allclose(action, a1[0].cpu().numpy(), rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_priority_scatter_on_a_side_stream_matches_plain_exactly():
    dev = _card()
    prio, idx, vals = scatter_case("mixed", 50_000, 64, 11)
    want = _plain(prio, idx, vals)
    got = torch.from_numpy(prio).to(dev)
    i, v = torch.from_numpy(idx).to(dev), torch.from_numpy(vals).to(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        priority_scatter(got, i, v)
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
def test_pipelined_executor_on_the_card():
    """pendulum_tiny through the pipelined executor on two streams: the
    schedule's counts, one scatter launch per learner step, finite
    priorities, and the collector's own modules."""
    from r2d2dpg_torch.configs import PENDULUM_TINY
    from r2d2dpg_torch.training.pipeline import PipelineConfig, PipelineExecutor

    dev = _card()
    trainer = PENDULUM_TINY.build(dev)
    ex = PipelineExecutor(trainer, PipelineConfig(enabled=True, queue_depth=2))
    assert ex.collector_nets[0] is not trainer.agent.actor
    warm, fill = trainer.window_fill_phases, trainer.replay_fill_phases
    n_train = 10
    before = PRIORITY_SCATTER.launches
    state = ex.run(warm + fill + n_train, log_every=3, log_fn=lambda *_: None)
    torch.cuda.synchronize()
    tc = PENDULUM_TINY.trainer
    assert PRIORITY_SCATTER.launches - before == n_train * tc.learner_steps
    assert state.train.step == n_train * tc.learner_steps
    assert state.env_steps == (warm + fill + n_train) * tc.stride * tc.num_envs
    assert trainer.arena.size(state.arena) == (fill + n_train) * tc.num_envs
    assert bool(torch.isfinite(state.arena.priority).all())
    assert ex.stats()["train_phases"] == n_train
