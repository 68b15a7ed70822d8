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
with one scatter launch per learner step.  The fleet: a read-only decoded
SEQS frame reaches the card intact (``put_staged``), a parameter snapshot
from the card equals the parameters and aliases none of them, and a drain
fed by a thread actor launches the scatter once per learner step.  The
sampler: a pulled batch (read-only decoded frame leaves) reaches the card
intact in one copy as ``[K, B]`` views, and a 2-shard sampler learner fed
by a thread actor learns on the card and launches the scatter not once.
Telemetry: ``flops_of`` of a pendulum_tiny learner step counts the same on
the card as on the CPU, and a 2-phase profile window over ``Trainer.run``
on the card holds one scatter kernel per learner step of the window.  The
dp learner's write-back on each rank's capacity block (1, 2 and 4 ranks,
the other ranks stood in for) equals the plain scatter on the whole vector.
A host env's step results reach the card through the pinned upload ring
bitwise, float32 and uint8 frames, after the ring wrapped.  The learner
step replayed as a CUDA graph (``agents/graph.py``) equals its eager body
bitwise over five steps at walker_r2d2's widths (fp32, TD3, bf16) and at
cheetah_pixels' with ``cudnn.deterministic`` (without it cuDNN's
convolution backward is not repeatable); a replay's outputs are copies
that later replays leave alone, also across streams; one capture a
signature; a capture while another thread launches and syncs on its own
stream; no garbage collection inside a capture.  The LSTM recurrence
kernel (``csrc/lstm_seq.cu``) equals its plain version, forward and
backward, at every shape of ``LSTM_SEQ_SHAPES`` to float32 rounding (as
close to the float64 recurrence as the plain version stands); a captured
graph of it replays bitwise its eager launches; it refuses a hidden size
or batch it does not take; an eager learner step at walker_r2d2's widths
launches it 10 times (bf16: none).
"""

import types

import numpy as np
import pytest
import torch

from r2d2dpg_torch.kernels import LSTM_SEQ, PRIORITY_SCATTER
from r2d2dpg_torch.models import ActorNet, policy_step_fn
from r2d2dpg_torch.ops.priority import PRIORITY_EPS
from r2d2dpg_torch.ops.scatter import priority_scatter, priority_scatter_plain
from r2d2dpg_torch.replay import ReplayArena, SequenceBatch
from r2d2dpg_torch.serving import PolicyService, SessionStore, gather_carries, scatter_carries
from r2d2dpg_torch.serving.service import expand_rows, rowwise_policy_step_fn
from r2d2dpg_torch.testing import (
    LSTM_SEQ_SHAPES,
    SCATTER_PATTERNS,
    lstm_seq_errors,
    lstm_seq_faults,
    lstm_seq_graph_replays,
    scatter_case,
)

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


@pytest.mark.cuda
def test_decoded_frame_reaches_the_card_intact():
    from r2d2dpg_torch.fleet import put_staged, wire
    from r2d2dpg_torch.replay import StagedSequences

    dev = _card()
    rng = np.random.default_rng(0)
    staged = StagedSequences(
        seq=SequenceBatch(
            obs=rng.normal(size=(4, 35, 3)).astype(np.float32),
            action=rng.normal(size=(4, 35, 1)).astype(np.float32),
            reward=rng.normal(size=(4, 35)).astype(np.float32),
            discount=np.ones((4, 35), np.float32),
            reset=np.zeros((4, 35), np.float32),
            carries={"actor": (rng.normal(size=(4, 128)).astype(np.float32),) * 2},
        ),
        priorities=rng.random(4).astype(np.float32),
        behavior_version=np.arange(4, dtype=np.int64),
        collect_id=np.arange(4, dtype=np.int64),
    )
    frame = b"".join(wire.TreePacker(wire.WireConfig()).pack({"s": staged}))
    decoded = wire.TreeUnpacker().unpack(frame)["s"]
    assert not decoded.seq.obs.flags.writeable
    on_card = put_staged([decoded, decoded], dev)
    torch.cuda.synchronize()
    assert on_card.seq.obs.device.type == "cuda"
    for got, want in ((on_card.seq.obs, staged.seq.obs),
                      (on_card.seq.carries["actor"][1], staged.seq.carries["actor"][1]),
                      (on_card.priorities, staged.priorities),
                      (on_card.collect_id, staged.collect_id)):
        assert np.array_equal(got.cpu().numpy(), np.concatenate([want, want]))
        assert got.dtype == torch.from_numpy(want).dtype


@pytest.mark.cuda
def test_param_snapshot_from_the_card_is_a_copy():
    from r2d2dpg_torch.configs import PENDULUM_TINY
    from r2d2dpg_torch.fleet import snapshot_params

    dev = _card()
    t = PENDULUM_TINY.build(dev)
    train = t.agent.init(torch.Generator().manual_seed(0), dev)
    snap = snapshot_params(train)
    for f in ("actor_params", "critic_params", "target_actor_params",
              "target_critic_params"):
        for k, v in getattr(train, f).items():
            assert isinstance(snap[f][k], np.ndarray)
            assert np.array_equal(snap[f][k], v.cpu().numpy())
    k0 = next(iter(train.actor_params))
    before = snap["actor_params"][k0].copy()
    train.actor_params[k0].add_(1.0)
    torch.cuda.synchronize()
    assert np.array_equal(snap["actor_params"][k0], before)


@pytest.mark.cuda
def test_fleet_drain_on_the_card_launches_once_per_learner_step():
    import threading

    from r2d2dpg_torch.configs import PENDULUM_TINY
    from r2d2dpg_torch.fleet import FleetActor, FleetConfig, FleetLearner

    dev = _card()
    trainer = PENDULUM_TINY.build(dev)
    learner = FleetLearner(trainer, FleetConfig(num_actors=1, idle_timeout_s=60))
    address = learner.start()
    actor = FleetActor(PENDULUM_TINY, actor_id=0, num_actors=1, address=address,
                       seed=0, device="cpu")

    def run():
        try:
            actor.run(max_phases=400)
        except Exception:  # noqa: BLE001 - server teardown cuts the socket
            pass

    th = threading.Thread(target=run, daemon=True)
    th.start()
    n = 5
    before = PRIORITY_SCATTER.launches
    try:
        state = learner.run(n, log_every=0)
    finally:
        learner.close()
        th.join(timeout=30)
    torch.cuda.synchronize()
    assert state.train.step == n * trainer.config.learner_steps
    assert PRIORITY_SCATTER.launches - before == n * trainer.config.learner_steps
    assert bool(torch.isfinite(state.arena.priority).all())


@pytest.mark.cuda
def test_pulled_batch_reaches_the_card_intact():
    from r2d2dpg_torch.configs import PENDULUM_TINY
    from r2d2dpg_torch.fleet import FleetConfig, SamplerLearner, wire

    dev = _card()
    t = PENDULUM_TINY.build(dev)
    data = t.init().arena.data
    rng = np.random.default_rng(0)
    n = t.config.learner_steps * t.config.batch_size
    seq = SequenceBatch(
        **{f: rng.normal(size=(n,) + tuple(getattr(data, f).shape[1:])).astype(np.float32)
           for f in ("obs", "action", "reward", "discount", "reset")},
        carries={k: tuple(rng.normal(size=(n,) + tuple(x.shape[1:])).astype(np.float32)
                          for x in v) for k, v in data.carries.items()},
    )
    frame = b"".join(wire.TreePacker(wire.WireConfig()).pack({"s": seq}))
    decoded = wire.TreeUnpacker().unpack(frame)["s"]
    assert not decoded.obs.flags.writeable
    probs = rng.random(n)
    learner = SamplerLearner(t, FleetConfig(num_actors=1), num_shards=1)
    seqs, pr = learner._place(decoded, probs)
    torch.cuda.synchronize()
    assert pr.device.type == "cuda" and pr.dtype == torch.float32
    assert np.array_equal(pr.cpu().numpy().ravel(), probs.astype(np.float32))
    assert np.array_equal(seqs.obs.cpu().numpy().reshape(seq.obs.shape), seq.obs)
    assert np.array_equal(seqs.carries["critic"][0].cpu().numpy().reshape(n, -1),
                          seq.carries["critic"][0])


@pytest.mark.cuda
def test_sampler_learner_on_the_card_launches_no_scatter():
    import threading

    from r2d2dpg_torch.configs import PENDULUM_TINY
    from r2d2dpg_torch.fleet import FleetActor, FleetConfig, SamplerLearner

    dev = _card()
    trainer = PENDULUM_TINY.build(dev)
    learner = SamplerLearner(trainer, FleetConfig(num_actors=1, idle_timeout_s=60),
                             num_shards=2)
    address = learner.start()
    actor = FleetActor(PENDULUM_TINY, actor_id=0, num_actors=1, address=address,
                       seed=0, device="cpu")

    def run():
        try:
            actor.run()
        except Exception:  # noqa: BLE001 - server teardown cuts the socket
            pass

    th = threading.Thread(target=run, daemon=True)
    th.start()
    n = 5
    before = PRIORITY_SCATTER.launches
    try:
        state = learner.run(n, log_every=0)
    finally:
        learner.close()
        th.join(timeout=30)
    torch.cuda.synchronize()
    assert state.train.step == n * trainer.config.learner_steps
    assert PRIORITY_SCATTER.launches == before
    assert next(iter(state.train.actor_params.values())).device.type == "cuda"
    assert learner.stats()["sheds"] == 0


def _filled_tiny(dev):
    """A pendulum_tiny trainer on ``dev`` and its state after warm-up and
    replay fill (seed 0)."""
    from r2d2dpg_torch.configs import PENDULUM_TINY

    trainer = PENDULUM_TINY.build(dev)
    state = trainer.init()
    warm, fill = trainer.window_fill_phases, trainer.replay_fill_phases
    for phase in range(warm + fill):
        state = trainer.collect_phase(state) if phase < warm else trainer.fill_phase(state)
    return trainer, state


@pytest.mark.cuda
def test_flops_of_a_learner_step_on_the_card_equals_the_cpu():
    """``FlopCounterMode`` counts the same products on the card as on the
    CPU, the backward included (autograd's CUDA thread sees the mode)."""
    from r2d2dpg_torch.obs.device import flops_of

    counts = {}
    for dev in ("cpu", _card()):
        trainer, state = _filled_tiny(dev)
        counts[str(dev)] = flops_of(
            trainer._learn_step, state.train, state.arena, state.draws)
    assert counts["cpu"] and counts["cpu"] == counts["cuda"], counts


@pytest.mark.cuda
def test_profile_window_on_the_card_holds_the_scatter(tmp_path):
    """A 2-phase ``--profile-window`` over ``Trainer.run`` on the card: the
    exported trace holds the scatter kernel once per learner step of the
    window."""
    import json
    import os

    from r2d2dpg_torch.obs import get_device_monitor

    dev = _card()
    trainer, state = _filled_tiny(dev)
    logdir = tmp_path / "profile_window"
    get_device_monitor().arm_profile("2:2", str(logdir))
    before = PRIORITY_SCATTER.launches
    state = trainer.run(state.phase_idx + 4, state, log_every=0)
    torch.cuda.synchronize()
    k = trainer.config.learner_steps
    assert PRIORITY_SCATTER.launches - before == 4 * k
    (name,) = os.listdir(logdir)
    events = json.loads((logdir / name).read_text())["traceEvents"]
    scatters = [e for e in events if e.get("cat") == "kernel"
                and "scatter_last_wins" in e.get("name", "")]
    assert len(scatters) == 2 * k, [e.get("name") for e in scatters]


class _RankOf:
    """Rank ``rank`` of a ``size``-rank mesh whose all-gather returns the
    whole batch's values (a stand-in for the other ranks on one card)."""

    def __init__(self, size, rank, everyone):
        self.size, self.rank, self._everyone = size, rank, everyone

    def block(self, n):
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    def all_gather(self, x):
        del x
        return self._everyone


@pytest.mark.cuda
@pytest.mark.parametrize("world", [1, 2, 4])
def test_block_write_back_on_every_rank_matches_plain_exactly(world):
    """The dp learner's write-back (``CapacityBlockArena.update_priorities``)
    on each rank's capacity block: the kernel at walker's B = 64 and
    capacity 100k, other blocks' indices moved past the block's end, equal
    to the plain scatter on the whole vector, sliced (bitwise)."""
    from r2d2dpg_torch.replay import CapacityBlockArena

    dev = _card()
    prio, idx, vals = scatter_case("mixed", 100_000, 64, seed=world)
    want = _plain(prio, idx, np.maximum(vals, PRIORITY_EPS))
    everyone = torch.from_numpy(np.maximum(vals, PRIORITY_EPS)).to(dev)
    got = []
    for rank in range(world):
        arena = CapacityBlockArena(100_000, _RankOf(world, rank, everyone))
        block = torch.from_numpy(prio[arena.lo:arena.lo + arena.block].copy()).to(dev)
        state = types.SimpleNamespace(priority=block)
        before = PRIORITY_SCATTER.launches
        arena.update_priorities(state, torch.from_numpy(idx).to(dev), everyone)
        torch.cuda.synchronize()
        assert PRIORITY_SCATTER.launches == before + 1
        got.append(state.priority.cpu().numpy())
    np.testing.assert_array_equal(np.concatenate(got), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_host_upload_ring_on_the_card(dtype):
    """A host env's step results reach the card in one packed copy through
    the pinned ring (``envs/core.py::HostUpload``): every step's tensors
    equal the host arrays (bitwise), also after the ring wrapped many times
    with a side stream's queued work ahead of each copy, and earlier steps'
    tensors keep their values while later steps reuse the host buffers."""
    from r2d2dpg_torch.envs.core import HostUpload

    dev = _card()
    up = HostUpload(dev)
    rng = np.random.default_rng(0)
    shape = (64, 24) if dtype == np.float32 else (8, 64, 64, 3)
    side = torch.cuda.Stream(dev)
    kept = []
    with torch.cuda.stream(side):
        for _ in range(3 * HostUpload.RING + 1):
            big = torch.ones(4096, 4096, device=dev)
            big @ big  # work queued ahead of the copy
            host = (rng.uniform(-1, 1, shape).astype(np.float32) if dtype == np.float32
                    else rng.integers(0, 256, shape, dtype=np.uint8))
            r, d, res = (rng.uniform(-1, 1, shape[0]).astype(np.float32) for _ in range(3))
            ts = up.upload(host, r, d, res)
            kept.append(((host, r, d, res), ts))
    torch.cuda.synchronize()
    for (host, r, d, res), ts in kept:
        assert ts.obs.device.type == "cuda" and ts.obs.dtype == torch.from_numpy(host).dtype
        np.testing.assert_array_equal(ts.obs.cpu().numpy(), host)
        for got, want in ((ts.reward, r), (ts.discount, d), (ts.reset, res)):
            np.testing.assert_array_equal(got.cpu().numpy(), want)


# ------------------------------------------------------------ learner graph
LEARNER_WIDTHS = {"walker_r2d2": ((24,), 6), "cheetah_pixels": ((64, 64, 3), 6)}


def _graph_counts():
    from r2d2dpg_torch.agents.graph import GRAPH_METRIC
    from r2d2dpg_torch.obs import get_registry

    inst = get_registry().get(GRAPH_METRIC)
    return {} if inst is None else {k: c.value for k, c in inst._cells_snapshot()}


def _graph_delta(before):
    return {k: v - before.get(k, 0.0) for k, v in _graph_counts().items()
            if v != before.get(k, 0.0)}


def _learner_case(name, dev, compute_dtype=None, **agent_kw):
    """An agent at config ``name``'s widths (agent knobs replaced by
    ``agent_kw``), its state from seed 0, and ``inputs(seed, b)``: a batch,
    IS weights and the smoothing normal (or None) of ``b`` rows on ``dev``."""
    import dataclasses

    from r2d2dpg_torch.configs import get_config

    cfg = get_config(name)
    cfg = dataclasses.replace(
        cfg, compute_dtype=compute_dtype or cfg.compute_dtype,
        agent=dataclasses.replace(cfg.agent, **agent_kw))
    obs_shape, act = LEARNER_WIDTHS[name]
    spec = types.SimpleNamespace(obs_shape=obs_shape, action_dim=act)
    agent = cfg.build_agent(types.SimpleNamespace(spec=spec))
    state = agent.init(torch.Generator().manual_seed(0), dev)
    acfg, hid = agent.config, cfg.hidden

    def inputs(seed, b=cfg.trainer.batch_size):
        rng = np.random.default_rng(seed)
        L = acfg.seq_len
        f = lambda *s: torch.from_numpy(  # noqa: E731
            rng.standard_normal(s).astype(np.float32)).to(dev)
        u = lambda *s: torch.from_numpy(rng.random(s).astype(np.float32)).to(dev)  # noqa: E731
        obs = (torch.from_numpy(rng.integers(0, 256, (b, L) + obs_shape, dtype=np.uint8)).to(dev)
               if cfg.pixels else f(b, L, *obs_shape))
        batch = SequenceBatch(
            obs=obs, action=2 * u(b, L, act) - 1, reward=f(b, L),
            discount=(u(b, L) > 0.05).float(), reset=(u(b, L) < 0.05).float(),
            carries={"actor": (0.5 * f(b, hid), 0.5 * f(b, hid)),
                     "critic": (0.5 * f(b, hid), 0.5 * f(b, hid))})
        normal = (f(acfg.unroll + acfg.n_step, b, act)
                  if acfg.target_policy_sigma > 0 else None)
        return batch, 0.2 + 0.8 * u(b), normal

    return agent, state, inputs


def _assert_same(a, b):
    from r2d2dpg_torch.tree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert torch.equal(x, y), i


LEARNER_GRAPH_CASES = {
    "walker": {},
    "walker_td3": dict(twin_critic=True, target_policy_sigma=0.2),
    "walker_bf16": dict(compute_dtype="bfloat16"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(LEARNER_GRAPH_CASES))
def test_graphed_learner_step_equals_the_eager_body_bitwise(case):
    """Five consecutive graphed steps at walker_r2d2's widths (B 64, seq
    43, hidden 256) equal the eager body's bitwise, from one state on the
    same batches: params, targets, both Adam states, priorities and every
    metric; one capture, then four replays."""
    dev = _card()
    agent, state, inputs = _learner_case("walker_r2d2", dev, **LEARNER_GRAPH_CASES[case])
    before = _graph_counts()
    graphed = eager = state
    for k in range(5):
        batch, w, normal = inputs(k)
        graphed, gp, gm = agent.learner_step(graphed, batch, w, normal)
        eager, ep, em = agent._learner_step_eager(eager, batch, w, normal)
        _assert_same((graphed, gp, gm), (eager, ep, em))
        assert graphed.step == eager.step and set(gm) == set(em)
    assert _graph_delta(before) == {("capture", ""): 1.0, ("replay", ""): 4.0}


@pytest.mark.cuda
def test_graphed_learner_step_at_the_cheetah_shapes_is_bitwise_with_deterministic_cudnn():
    """cheetah_pixels (64x64x3 frames, B 32, seq 45): with
    ``cudnn.deterministic`` the convolutions repeat, and five graphed steps
    equal the eager body's bitwise.  Without it cuDNN's convolution
    backward is not repeatable: two eager runs of these steps differ by a
    loss gap of up to 5.1e-5 after three steps and 9.8e-4 after five (an
    H100), past the benchmark's limit of 5e-6, so no tolerance would tell
    the graph from that noise; the benchmark's own cheetah runs hold the
    graphed step to its limits against the reference."""
    dev = _card()
    torch.backends.cudnn.deterministic = True
    try:
        agent, state, inputs = _learner_case("cheetah_pixels", dev)
        graphed = eager = state
        for k in range(5):
            batch, w, normal = inputs(k)
            graphed, gp, gm = agent.learner_step(graphed, batch, w, normal)
            eager, ep, em = agent._learner_step_eager(eager, batch, w, normal)
            _assert_same((graphed, gp, gm), (eager, ep, em))
    finally:
        torch.backends.cudnn.deterministic = False


@pytest.mark.cuda
def test_graphed_learner_steps_leave_earlier_states_intact():
    """The state a replay returns is a copy: step k's params, moments and
    priorities keep their values while steps k+1 and k+2 replay the graph
    (k+1 on a side stream, k+2 back on the default one), and each step
    still equals the eager body's bitwise."""
    from r2d2dpg_torch.tree import tree_leaves

    dev = _card()
    agent, state, inputs = _learner_case("walker_r2d2", dev)
    side = torch.cuda.Stream(dev)
    graphed = eager = state
    kept = []
    for k in range(4):
        batch, w, normal = inputs(k)
        if k == 2:
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                out = agent.learner_step(graphed, batch, w, normal)
            torch.cuda.current_stream(dev).wait_stream(side)
        else:
            out = agent.learner_step(graphed, batch, w, normal)
        graphed = out[0]
        eager_out = agent._learner_step_eager(eager, batch, w, normal)
        eager = eager_out[0]
        _assert_same(out, eager_out)
        kept.append((out, [x.clone() for x in tree_leaves(out)]))
    torch.cuda.synchronize()
    for out, copies in kept:
        for x, c in zip(tree_leaves(out), copies):
            assert torch.equal(x, c)


@pytest.mark.cuda
def test_learner_graph_counts_one_capture_per_signature():
    """N same-shape steps count 1 capture and N - 1 replays; a new batch
    size captures a second graph; the first size then replays again."""
    dev = _card()
    agent, state, inputs = _learner_case("walker_r2d2", dev)
    before = _graph_counts()
    for k in range(4):
        state, _, _ = agent.learner_step(state, *inputs(k))
    assert _graph_delta(before) == {("capture", ""): 1.0, ("replay", ""): 3.0}
    state, _, _ = agent.learner_step(state, *inputs(9, b=32))
    state, _, _ = agent.learner_step(state, *inputs(10))
    assert _graph_delta(before) == {("capture", ""): 2.0, ("replay", ""): 4.0}


@pytest.mark.cuda
def test_learner_graph_captures_while_another_thread_launches():
    """A capture succeeds while another thread keeps allocating and
    launching on its own stream, and the replayed step equals the eager
    body's bitwise."""
    import threading

    dev = _card()
    agent, state, inputs = _learner_case("walker_r2d2", dev)
    started, stop, launched = threading.Event(), threading.Event(), []

    def busy():
        s = torch.cuda.Stream(dev)
        with torch.cuda.stream(s):
            while not stop.is_set():
                x = torch.full((512, 512), 1.0 / 512, device=dev)
                launched.append(float((x @ x).sum()))  # a sync, off the capture
                started.set()

    th = threading.Thread(target=busy, daemon=True)
    th.start()
    try:
        assert started.wait(timeout=60)
        before = _graph_counts()
        batch, w, normal = inputs(0)
        out = agent.learner_step(state, batch, w, normal)
        seen = len(launched)
        out2 = agent.learner_step(out[0], *inputs(1))
    finally:
        stop.set()
        th.join(timeout=30)
    assert not th.is_alive()
    assert _graph_delta(before) == {("capture", ""): 1.0, ("replay", ""): 1.0}
    assert len(launched) > seen > 1
    eager = agent._learner_step_eager(state, batch, w, normal)
    _assert_same(out, eager)
    _assert_same(out2, agent._learner_step_eager(eager[0], *inputs(1)))


@pytest.mark.cuda
def test_learner_graph_captures_with_the_collector_off():
    """No garbage collection runs inside a capture (a collected graph of a
    dropped agent would be destroyed there, which invalidates the
    capture): the body sees the collector off while its stream captures,
    and on again afterwards."""
    import gc

    dev = _card()
    agent, state, inputs = _learner_case("walker_r2d2", dev)
    seen = []
    body = agent._learner_step_eager

    def spy(*args, **kwargs):
        seen.append((torch.cuda.is_current_stream_capturing(), gc.isenabled()))
        return body(*args, **kwargs)

    agent._learner_step_eager = spy
    assert gc.isenabled()
    agent.learner_step(state, *inputs(0))
    assert seen == [(False, True), (True, False)]  # warm-up, then the capture
    assert gc.isenabled()


# ------------------------------------------------------- LSTM recurrence
@pytest.mark.cuda
@pytest.mark.parametrize("shape", LSTM_SEQ_SHAPES, ids=[s[0] for s in LSTM_SEQ_SHAPES])
def test_lstm_seq_kernel_matches_plain(shape):
    """Forward, backward and backward with the carry's gradient: each
    output within ``LSTM_SEQ_GAP`` of the plain version's largest
    magnitude, and as close to the float64 recurrence as the plain float32
    version stands, within ``LSTM_SEQ_F64`` times its gap."""
    dev = _card()
    _, e, t, b, h = shape
    before = LSTM_SEQ.launches
    errs = lstm_seq_errors(e, t, b, h, seed=e * t + b, device=dev)
    torch.cuda.synchronize()
    assert LSTM_SEQ.launches == before + 3  # the forward, two backwards
    outputs = {k[: -len("_gap")] for k in errs if k.endswith("_gap")}
    assert outputs == {"y", "c_last", "gates", "cs", "dz", "dz_carry", "dc0_carry",
                       "dh0_carry"}
    assert lstm_seq_faults(errs) == [], errs


@pytest.mark.cuda
def test_lstm_seq_kernel_replays_in_a_cuda_graph():
    """The forward and both backwards captured in one graph and replayed
    on fresh inputs equal eager launches on those inputs bitwise; the
    capture counts 3 launches and the replays none."""
    dev = _card()
    before = LSTM_SEQ.launches
    assert lstm_seq_graph_replays(dev) == [True, True]
    assert LSTM_SEQ.launches == before + 3 + 3 + 2 * 3  # warm-up, capture, eager


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["hidden_64", "hidden_96", "hidden_512"])
def test_lstm_seq_kernel_raises_on_shapes_it_does_not_take(bad):
    from r2d2dpg_torch.ops.lstm_seq import lstm_seq_fwd

    dev = _card()
    e, t, b, h = {"hidden_64": (1, 4, 8, 64), "hidden_96": (1, 4, 8, 96),
                  "hidden_512": (1, 4, 8, 512)}[bad]
    z = lambda *s: torch.zeros(s, device=dev)  # noqa: E731
    before = LSTM_SEQ.launches
    with pytest.raises(ValueError, match="lstm_seq: the kernel takes"):
        lstm_seq_fwd(z(e, t, b, 4 * h), z(e, 4 * h, h), z(e, 4 * h), z(e, b, h), z(e, b, h),
                     torch.zeros(t, b, dtype=torch.bool, device=dev), False)
    assert LSTM_SEQ.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["walker", "walker_td3", "walker_bf16"])
def test_learner_unrolls_take_the_kernel_on_the_card(case):
    """An eager learner step at walker_r2d2's widths launches the kernel 7
    times forward (burn-in fused: 2, targets 2, the critic's unroll, the
    actor loss's 2) and 3 backward (the critic's, the actor loss's actor
    and critic), and counts its 7 unrolls as the sequence form; bf16 nets
    launch none and count the step form."""
    from r2d2dpg_torch.agents.ddpg import UNROLL_METRIC
    from r2d2dpg_torch.obs import get_registry

    dev = _card()
    agent, state, inputs = _learner_case("walker_r2d2", dev, **LEARNER_GRAPH_CASES[case])

    def unrolls():
        inst = get_registry().get(UNROLL_METRIC)
        return {} if inst is None else {k: c.value for k, c in inst._cells_snapshot()}

    before, counted = LSTM_SEQ.launches, unrolls()
    agent._learner_step_eager(state, *inputs(0))
    torch.cuda.synchronize()
    delta = {k: v - counted.get(k, 0.0) for k, v in unrolls().items()
             if v != counted.get(k, 0.0)}
    if case == "walker_bf16":
        assert LSTM_SEQ.launches == before
        assert delta == {("step", "mixed_precision"): 7.0}
    else:
        assert LSTM_SEQ.launches == before + 10
        assert delta == {("sequence", "float32"): 7.0}
