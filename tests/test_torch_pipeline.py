"""Port parity: the pipelined collect/learn executor, the prefetched learner
steps and the staged arena API, against the port's own phase-locked path
and the JAX package (``tests/test_pipeline.py`` is the model).

- ``PipelineExecutor(enabled=False)`` equals ``Trainer.run`` leaf for leaf,
  bitwise (pendulum_tiny, 14 phases, log every 3).
- ``_learn_many(prefetch=True)`` with uniform replay equals the sequential
  branch bitwise, given the same injected draws.
- ``_learn_many(prefetch=True)`` with prioritized replay against the JAX
  ``Trainer._learn_many(..., prefetch=True)`` from one converted state,
  the JAX uniforms (and smoothing normals) injected in the port's prefetch
  order (``training/draws.py``): params and priorities atol 1e-5, rtol
  1e-4; metrics the same (as in ``test_torch_trainer.py``).
- ``add_staged`` equals ``add`` and the JAX ``add_staged`` on the same
  sequences, priorities and stamp (exact: both only copy values).
- split / merge, progress counts and ``stats()`` keys (JAX's, plus the
  port's ``learn_phases``), module isolation, errors, the CLI.
"""

import dataclasses
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2dpg_tpu.configs import PENDULUM_TINY as J_TINY
from r2d2dpg_tpu.replay.arena import StagedSequences as JStaged
from r2d2dpg_tpu.replay.arena import stack_staged as j_stack_staged
from r2d2dpg_tpu.training.assembler import emit as j_emit
from r2d2dpg_tpu.training.pipeline import PipelineConfig as JPipelineConfig
from r2d2dpg_tpu.training.pipeline import PipelineExecutor as JPipelineExecutor
from r2d2dpg_torch.configs import PENDULUM_TINY
from r2d2dpg_torch.convert import (
    net_params_from_flax,
    sequence_batch_from_jax,
    trainer_state_from_jax,
)
from r2d2dpg_torch.replay import StagedSequences, stack_staged
from r2d2dpg_torch.training import ReplayDraws
from r2d2dpg_torch.training.assembler import emit
from r2d2dpg_torch.training.pipeline import (
    PipelineConfig,
    PipelineExecutor,
    bucket_width,
    coalesce_from_queue,
    merge_state,
    split_state,
)
from r2d2dpg_torch.tree import tree_leaves, tree_map

pytestmark = pytest.mark.pipeline

N_PHASES = 14  # PENDULUM_TINY: 2 warm + 2 fill + 10 train
LOG_EVERY = 3  # off-cadence vs N_PHASES, so mid-run drains are exercised
TOL = dict(atol=1e-5, rtol=1e-4)


def _t(x):
    return torch.tensor(np.asarray(x))


def _tiny(**trainer):
    return dataclasses.replace(
        PENDULUM_TINY, trainer=dataclasses.replace(PENDULUM_TINY.trainer, **trainer))


def _clone_arena(a):
    return dataclasses.replace(a, data=tree_map(torch.clone, a.data),
                               priority=a.priority.clone(), meta=a.meta.clone())


def _counters(s):
    """The Python-int fields of a trainer state and its arena/learner."""
    t = s.train
    return (s.phase_idx, s.env_steps, s.arena.cursor, s.arena.total_added,
            t.step, t.actor_opt_state.count, t.critic_opt_state.count)


def _assert_states_bitwise(a, b):
    la, lb = tree_leaves(dataclasses.replace(a, draws=None)), tree_leaves(
        dataclasses.replace(b, draws=None))
    assert len(la) == len(lb)
    bad = [i for i, (x, y) in enumerate(zip(la, lb)) if not torch.equal(x, y)]
    assert not bad, f"state diverged at leaves {bad}"
    assert _counters(a) == _counters(b)
    assert torch.equal(a.draws.generator.get_state(), b.draws.generator.get_state())


def test_pipeline_off_equals_trainer_run_bitwise():
    s1 = PENDULUM_TINY.build("cpu").run(N_PHASES, log_every=LOG_EVERY, log_fn=lambda *_: None)
    ex = PipelineExecutor(PENDULUM_TINY.build("cpu"), PipelineConfig(enabled=False))
    s2 = ex.run(N_PHASES, log_every=LOG_EVERY, log_fn=lambda *_: None)
    _assert_states_bitwise(s1, s2)


def test_prefetch_uniform_replay_equals_sequential_bitwise():
    t = _tiny(prioritized=False, learner_steps=3).build("cpu")
    s = t.run(6, log_every=0)
    b = t.config.batch_size
    u = [torch.rand(b, generator=torch.Generator().manual_seed(i)) for i in range(3)]
    out = {}
    for prefetch in (False, True):
        arena = _clone_arena(s.arena)
        draws = ReplayDraws(list(u))
        out[prefetch] = t._learn_many(s.train, arena, draws, prefetch=prefetch)
        assert draws.remaining() == 0
    (seq_train, seq_arena, seq_m), (pre_train, pre_arena, pre_m) = out[False], out[True]
    for x, y in zip(tree_leaves(seq_train), tree_leaves(pre_train), strict=True):
        assert torch.equal(x, y)
    assert torch.equal(seq_arena.priority, pre_arena.priority)
    assert seq_m.keys() == pre_m.keys()
    for k in seq_m:
        assert torch.equal(seq_m[k], pre_m[k]), k


def _prefetch_draws(key, k_steps, batch, smoothing_shape):
    """The JAX prefetch scan's draws in the port's prefetch order."""
    keys = jax.random.split(key, k_steps)
    u = [jax.random.uniform(k, (batch,)) for k in keys]
    n = [None if smoothing_shape is None
         else jax.random.normal(jax.random.fold_in(k, 1), smoothing_shape)
         for k in keys]
    draws = [u[0]]
    for k in range(k_steps):
        if k + 1 < k_steps:
            draws.append(u[k + 1])
        if n[k] is not None:
            draws.append(n[k])
    return [_t(x) for x in draws]


@pytest.mark.parametrize("sigma", [0.0, 0.2], ids=["plain", "smoothing"])
def test_prefetch_prioritized_matches_jax(sigma):
    k_steps = 3
    jcfg = dataclasses.replace(
        J_TINY,
        trainer=dataclasses.replace(J_TINY.trainer, learner_steps=k_steps),
        agent=dataclasses.replace(J_TINY.agent, target_policy_sigma=sigma),
    )
    tcfg = dataclasses.replace(
        _tiny(learner_steps=k_steps),
        agent=dataclasses.replace(PENDULUM_TINY.agent, target_policy_sigma=sigma),
    )
    jt = jcfg.build()
    js = jt.run(6, log_every=0)
    host = jax.device_get(js)
    key = jax.random.PRNGKey(3)
    acfg = jcfg.agent
    shape = None if sigma == 0 else (acfg.unroll + acfg.n_step, jcfg.trainer.batch_size, 1)
    draws = ReplayDraws(_prefetch_draws(key, k_steps, jcfg.trainer.batch_size, shape))
    jtrain, jarena, jm = jax.device_get(
        jt._learn_many(js.train, js.arena, key, prefetch=True))

    tt = tcfg.build("cpu")
    ts = trainer_state_from_jax(host, None, device="cpu")
    train, arena, m = tt._learn_many(ts.train, ts.arena, draws, prefetch=True)
    assert draws.remaining() == 0
    assert train.step == int(jtrain.step) == int(host.train.step) + k_steps
    np.testing.assert_allclose(arena.priority.numpy(), jarena.priority, **TOL)
    assert not np.array_equal(np.asarray(jarena.priority), np.asarray(host.arena.priority))
    for name in ("actor_params", "critic_params", "target_actor_params",
                 "target_critic_params"):
        want = net_params_from_flax(getattr(jtrain, name))
        for k, v in want.items():
            np.testing.assert_allclose(getattr(train, name)[k].numpy(), v.numpy(),
                                       **TOL, err_msg=f"{name}.{k}")
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), **TOL, err_msg=k)


# ------------------------------------------------------------- staged adds
def test_add_staged_equals_add_and_refuses_unresolved():
    t = PENDULUM_TINY.build("cpu")
    s = t.run(5, log_every=0)
    seq = emit(s.window)
    prios = torch.arange(1.0, 1.0 + t.config.num_envs)
    direct = t.arena.add(_clone_arena(s.arena), seq, prios)
    staged = t.arena.add_staged(
        _clone_arena(s.arena), StagedSequences(seq=seq, priorities=prios))
    for x, y in zip(tree_leaves(direct), tree_leaves(staged), strict=True):
        assert torch.equal(x, y)
    assert (direct.cursor, direct.total_added) == (staged.cursor, staged.total_added)
    with pytest.raises(ValueError, match="resolved priorities"):
        t.arena.add_staged(s.arena, StagedSequences(seq=seq, priorities=None))


@pytest.fixture(scope="module")
def jax_tiny_after_5_phases():
    jt = J_TINY.build()
    return jt, jt.run(5, log_every=0)


@pytest.mark.parametrize("provenance", [False, True], ids=["stamp", "stamp+version"])
def test_add_staged_matches_jax(jax_tiny_after_5_phases, provenance):
    jt, js = jax_tiny_after_5_phases
    host = jax.device_get(js)
    jseq = j_emit(js.window)
    e = J_TINY.trainer.num_envs
    prios = np.linspace(0.5, 2.0, e).astype(np.float32)
    version = np.arange(10, 10 + e, dtype=np.int64) if provenance else None
    jarena = jax.device_get(jt.arena.add_staged(
        js.arena, JStaged(seq=jseq, priorities=jnp.asarray(prios),
                          behavior_version=version), stamp=7))
    t = PENDULUM_TINY.build("cpu")
    ts = trainer_state_from_jax(host, None, device="cpu")
    arena = t.arena.add_staged(ts.arena, StagedSequences(
        seq=sequence_batch_from_jax(jax.device_get(jseq), "cpu"),
        priorities=torch.from_numpy(prios),
        behavior_version=None if version is None else torch.from_numpy(version)),
        stamp=7)
    assert arena.cursor == int(jarena.cursor)
    assert arena.total_added == int(jarena.total_added)
    np.testing.assert_array_equal(arena.priority.numpy(), jarena.priority)
    np.testing.assert_array_equal(arena.meta.numpy(), jarena.meta)
    want = sequence_batch_from_jax(jarena.data, "cpu")
    for x, y in zip(tree_leaves(arena.data), tree_leaves(want), strict=True):
        assert torch.equal(x, y)


def test_add_staged_refuses_a_second_writer():
    t = PENDULUM_TINY.build("cpu")
    s = t.run(5, log_every=0)
    staged = StagedSequences(seq=emit(s.window), priorities=torch.ones(t.config.num_envs))
    holding, release = threading.Event(), threading.Event()

    def hold():
        with t.arena.staged_writer():
            holding.set()
            release.wait(30)

    th = threading.Thread(target=hold)
    th.start()
    try:
        assert holding.wait(30)
        with pytest.raises(RuntimeError, match="single-writer"):
            t.arena.add_staged(s.arena, staged)
    finally:
        release.set()
        th.join(30)
    assert not th.is_alive()
    with t.arena.staged_writer():  # re-entrant on the holding thread
        t.arena.add_staged(s.arena, staged)


def test_stack_staged_matches_jax():
    rng = np.random.default_rng(0)
    parts = [dict(obs=rng.standard_normal((n, 5, 3)).astype(np.float32),
                  prio=rng.random(n).astype(np.float32)) for n in (2, 3)]

    def batch(p, seq_cls):
        z = np.zeros(p["obs"].shape[:2], np.float32)
        return seq_cls(obs=p["obs"], action=p["obs"][..., :1], reward=z, discount=z,
                       reset=z, carries={"actor": (), "critic": ()})

    from r2d2dpg_tpu.replay.arena import SequenceBatch as JBatch

    want = j_stack_staged([JStaged(seq=batch(p, JBatch), priorities=p["prio"]) for p in parts])
    got = stack_staged([StagedSequences(
        seq=sequence_batch_from_jax(batch(p, JBatch), "cpu"),
        priorities=torch.from_numpy(p["prio"])) for p in parts])
    np.testing.assert_array_equal(got.seq.obs.numpy(), want.seq.obs)
    np.testing.assert_array_equal(got.priorities.numpy(), want.priorities)
    assert got.behavior_version is None and want.behavior_version is None
    mixed = [StagedSequences(seq=got.seq, priorities=None), got]
    with pytest.raises(ValueError, match="cannot mix"):
        stack_staged(mixed)


def test_bucket_width_and_coalesce_match_jax():
    import queue

    from r2d2dpg_tpu.training.pipeline import bucket_width as j_bucket_width

    for avail in range(0, 20):
        for limit in (1, 2, 4, 7, 8):
            assert bucket_width(avail, limit) == j_bucket_width(avail, limit)
    q = queue.Queue()
    for i in range(5):
        q.put(i)
    assert coalesce_from_queue(q, "first", 4) == ["first", 0, 1, 2]
    assert q.qsize() == 2


# ------------------------------------------------- split, merge, progress
def test_split_merge_round_trip_and_forked_draws():
    t = PENDULUM_TINY.build("cpu")
    state = t.init()
    cstate, lstate = split_state(state)
    assert cstate.draws is state.draws  # the collector keeps the stream
    merged = merge_state(state, cstate, lstate, behavior_params=state.behavior_params)
    _assert_states_bitwise(state, merged)
    # The learner's generator is a second stream, and the fork drew nothing
    # from the state's.
    before = state.draws.generator.get_state()
    again = split_state(state)[1]
    assert torch.equal(state.draws.generator.get_state(), before)
    assert again.draws.generator.initial_seed() == lstate.draws.generator.initial_seed()
    assert lstate.draws.generator.initial_seed() != state.draws.generator.initial_seed()
    assert not torch.equal(lstate.draws.uniform((8,)), cstate.draws.uniform((8,)))
    with pytest.raises(TypeError, match="Draws"):
        split_state(dataclasses.replace(state, draws=ReplayDraws([])))


@pytest.fixture(scope="module")
def jax_stats_keys():
    ex = JPipelineExecutor(J_TINY.build(), JPipelineConfig(enabled=True, queue_depth=2))
    ex.run(6, log_every=0)
    return set(ex.stats())


def test_pipelined_executor_makes_progress(jax_stats_keys):
    cfg = PENDULUM_TINY
    t = cfg.build("cpu")
    ex = PipelineExecutor(t, PipelineConfig(enabled=True, queue_depth=2))
    logged = []
    s = ex.run(N_PHASES, log_every=LOG_EVERY,
               metrics_fn=lambda phase, scalars: logged.append((phase, scalars)))
    warm, fill = t.window_fill_phases, t.replay_fill_phases
    n_train = N_PHASES - warm - fill
    tc = cfg.trainer
    assert s.train.step == n_train * tc.learner_steps
    assert s.env_steps == N_PHASES * tc.stride * tc.num_envs
    assert s.phase_idx == N_PHASES
    assert t.arena.size(s.arena) == (fill + n_train) * tc.num_envs
    stats = ex.stats()
    assert stats["train_phases"] == n_train == stats["learn_phases"]
    assert 0.0 <= stats["overlap_fraction"] <= 1.0
    assert stats["learner_steps_per_sec"] > 0
    assert stats["compile_count"] == 0.0
    assert set(stats) == jax_stats_keys | {"learn_phases"}
    assert ex.learner_wait.count == n_train + 1  # + the sentinel's wait
    assert ex.collect_wait.count == n_train
    assert [p for p, _ in logged] == [
        p for p in range(1, N_PHASES + 1) if p % LOG_EVERY == 0]
    for phase, scalars in logged:
        assert "env_steps" in scalars and "episode_return_mean" in scalars
        if phase > warm + fill:
            assert scalars["learner_steps"] == (phase - warm - fill) * tc.learner_steps
            assert np.isfinite(scalars["critic_loss"])
    assert torch.isfinite(s.arena.priority).all()


def test_collector_never_runs_the_learner_modules():
    t = PENDULUM_TINY.build("cpu")
    ex = PipelineExecutor(t, PipelineConfig(enabled=True))
    actor, critic = ex.collector_nets
    assert actor is not t.agent.actor and critic is not t.agent.critic
    assert not {p.data_ptr() for p in actor.parameters()} & {
        p.data_ptr() for p in t.agent.actor.parameters()}
    seen = {"agent": set(), "collector": set()}

    def spy(module, who):
        plain = module.apply_params

        def apply_params(*args):
            seen[who].add(threading.current_thread().name)
            return plain(*args)

        module.apply_params = apply_params

    for m in (t.agent.actor, t.agent.critic):
        spy(m, "agent")
    for m in ex.collector_nets:
        spy(m, "collector")
    ex.run(N_PHASES, log_every=0)
    assert seen["collector"] == {"pipeline-collector"}
    assert "pipeline-collector" not in seen["agent"]
    assert seen["agent"]  # warm-up, fill and the learner ran the agent's


def test_collector_error_surfaces_on_the_caller():
    t = PENDULUM_TINY.build("cpu")
    ex = PipelineExecutor(t, PipelineConfig(enabled=True))

    def boom(*_):
        raise RuntimeError("collector boom")

    ex._collect_phase_pipelined = boom
    with pytest.raises(RuntimeError, match="collector boom"):
        ex.run(N_PHASES, log_every=0)
    assert not any(th.name == "pipeline-collector" for th in threading.enumerate())


def test_executor_refuses_shard_map_and_host_driven_trainers():
    with pytest.raises(ValueError, match="shard_map"):
        PipelineExecutor(types.SimpleNamespace(axis="dp"))
    # Host-driven collection runs at world size 1 (test_torch_hybrid.py);
    # at a world of 2 its two threads would share one process group.
    with pytest.raises(ValueError, match="host-driven"):
        PipelineExecutor(types.SimpleNamespace(axis=None, _host_collect=None,
                                               mesh=types.SimpleNamespace(size=2)))
    with pytest.raises(ValueError, match="queue_depth"):
        PipelineExecutor(PENDULUM_TINY.build("cpu"), PipelineConfig(queue_depth=0))


# ---------------------------------------------------------------------- CLI
def test_pipelined_cli_prints_stats_and_writes_the_trace(tmp_path, capsys):
    import json

    from r2d2dpg_torch.obs import get_flight_recorder
    from r2d2dpg_torch.train import main

    from r2d2dpg_torch.utils.checkpoint import CheckpointManager

    get_flight_recorder().clear_spans()
    logdir, ckdir = tmp_path / "log", tmp_path / "ck"
    state = main(["--config", "pendulum_tiny", "--pipeline", "1", "--phases", "3",
                  "--device", "cpu", "--log-every", "1", "--trace-sample", "1",
                  "--logdir", str(logdir), "--checkpoint-dir", str(ckdir),
                  "--checkpoint-every", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "backend: cpu"
    # Periodic saves fall back, loudly, to the final save only.
    assert any("periodic checkpoints not supported" in line for line in out)
    assert CheckpointManager(str(ckdir)).all_steps() == [7]
    stats = [line for line in out
             if line.startswith("pipeline: ") and "overlap_fraction" in line]
    assert len(stats) == 1 and stats[0] == out[-1]
    assert [line.split()[1] for line in out if line.startswith("phase ")] == [
        f"{p}/7" for p in range(1, 8)]
    assert state.train.step == 3 and state.phase_idx == 7
    trace = json.loads((logdir / "trace.json").read_text())
    names = [e["name"] for e in trace["traceEvents"]]
    for hop in ("collect", "enqueue", "arena_add", "learn"):
        assert names.count(hop) == 3, hop
    assert all(e["ph"] == "X" for e in trace["traceEvents"])


@pytest.mark.parametrize("pipeline", ["0", "1"])
def test_nan_injection_trips_the_watchdog_and_exits_2(tmp_path, pipeline):
    import json

    from r2d2dpg_torch.train import main

    logdir = tmp_path / "log"
    with pytest.raises(SystemExit) as exc:
        main(["--config", "pendulum_tiny", "--pipeline", pipeline, "--phases", "4",
              "--device", "cpu", "--log-every", "1", "--nan-inject-phase", "1",
              "--logdir", str(logdir)])
    assert exc.value.code == 2
    events = [json.loads(line) for line in (logdir / "flight.jsonl").open()]
    kinds = [e["kind"] for e in events]
    assert "watchdog_trip" in kinds and "abort" in kinds
    trip = next(e for e in events if e["kind"] == "watchdog_trip")
    assert "non-finite" in trip["reason"]
