"""Port parity: the actor fleet (``r2d2dpg_torch/fleet/``, ``train --actors N``).

Against the JAX package: the per-actor sigma-ladder slice (exact, float32
ladder math), an actor's collect phases with converted params and the JAX
program's draws injected (env, window, emitted sequences and local
priorities within atol 1e-5, rtol 1e-4, as the trainer parity tests), the
supervisor's fake-clock restart schedule (exact), the train CLI's
refusals (same rows, same matches) and ``--actors 0`` bitwise equal to
``Trainer.run``.  On the port alone: a thread actor drained by
``FleetLearner`` on f32 and on bf16 + zlib coalesced, ingest ack/shed/
param push and the wire-mismatch refusal, ``put_staged``, the counter
sidecar and an in-process resume, the spawner's argv and environment
(CPU only, the token never in argv), no agent module called off the
learner's thread, and the CLI with real actor subprocesses.
"""

import dataclasses
import json
import os
import queue
import re
import sys
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2dpg_tpu.configs import PENDULUM_TINY as J_TINY
from r2d2dpg_torch.configs import PENDULUM_TINY
from r2d2dpg_torch.convert import net_params_from_flax, trainer_state_from_jax
from r2d2dpg_torch.fleet import (
    ActorSupervisor,
    FleetActor,
    FleetConfig,
    FleetLearner,
    IngestServer,
    SupervisorConfig,
    build_actor_trainer,
    default_actor_argv,
    load_fleet_counters,
    prune_fleet_counters,
    put_staged,
    save_fleet_counters,
    snapshot_params,
    structural_argv,
    transport,
    wire,
)
from r2d2dpg_torch.fleet.transport import (
    K_ACK,
    K_HELLO,
    K_PARAMS,
    K_SEQS,
    pack_hello,
    recv_frame,
    send_frame,
    send_frame_parts,
    unpack_obj,
)
from r2d2dpg_torch.obs import get_flight_recorder
from r2d2dpg_torch.replay.arena import SequenceBatch, StagedSequences, stack_staged
from r2d2dpg_torch.training import ReplayDraws
from r2d2dpg_torch.training.pipeline import _COLLECT_FIELDS, CollectorState
from r2d2dpg_torch.utils.checkpoint import CheckpointManager
from r2d2dpg_torch.utils.codes import EXIT_WIRE_REFUSED, OK, REFUSED_WIRE, SHED_INGEST
from test_torch_pipeline import _assert_states_bitwise

pytestmark = pytest.mark.fleet

TOL = dict(atol=1e-5, rtol=1e-4)
N_TRAIN = 6
PARAM_FIELDS = ("actor_params", "critic_params", "target_actor_params",
                "target_critic_params")


def _np_staged(b=2, length=3, seed=1, priorities=True, provenance=False):
    rng = np.random.default_rng(seed)
    return StagedSequences(
        seq=SequenceBatch(
            obs=rng.normal(size=(b, length, 3)).astype(np.float32),
            action=rng.normal(size=(b, length, 1)).astype(np.float32),
            reward=rng.normal(size=(b, length)).astype(np.float32),
            discount=np.ones((b, length), np.float32),
            reset=np.zeros((b, length), np.float32),
            carries={"actor": (rng.normal(size=(b, 4)).astype(np.float32),
                               rng.normal(size=(b, 4)).astype(np.float32))},
        ),
        priorities=np.arange(1.0, b + 1.0, dtype=np.float32) if priorities else None,
        behavior_version=np.full((b,), 3, np.int64) if provenance else None,
        collect_id=np.arange(b, dtype=np.int64) if provenance else None,
    )


def _swallow(fn, *a):
    try:
        fn(*a)
    except Exception:  # noqa: BLE001 - server teardown cuts the socket
        pass


# ------------------------------------------------------------- noise ladder
@pytest.mark.parametrize("num_actors", [1, 2, 3, 5])
@pytest.mark.parametrize("num_envs", [1, 4, 7])
def test_ladder_slice_equals_jax(num_actors, num_envs):
    from r2d2dpg_tpu.fleet.actor import build_actor_trainer as j_build

    jcfg = dataclasses.replace(J_TINY, trainer=dataclasses.replace(
        J_TINY.trainer, num_envs=num_envs))
    pcfg = dataclasses.replace(PENDULUM_TINY, trainer=dataclasses.replace(
        PENDULUM_TINY.trainer, num_envs=num_envs))
    for i in range(num_actors):
        want = np.asarray(j_build(jcfg, actor_index=i, num_actors=num_actors)
                          ._local_sigmas())
        t = build_actor_trainer(pcfg, actor_index=i, num_actors=num_actors,
                                device="cpu")
        np.testing.assert_allclose(t.sigmas.numpy(), want, rtol=1e-6, atol=0)
        assert t.arena.capacity == num_envs  # the tiny actor arena
    with pytest.raises(ValueError, match="outside fleet"):
        build_actor_trainer(pcfg, actor_index=num_actors, num_actors=num_actors,
                            device="cpu")


def test_base_trainer_ladder_unchanged():
    """The hook left the phase-locked trainer's ladder as it was."""
    from r2d2dpg_torch.ops import sigma_ladder

    t = PENDULUM_TINY.build("cpu")
    c = t.config
    assert torch.equal(t.sigmas, sigma_ladder(
        c.num_envs, sigma_max=c.sigma_max, alpha=c.ladder_alpha,
        kind=c.ladder_kind))


# ------------------------------------------------------- actor collect parity
def _collect_draws(rng, tcfg, action_dim):
    """One JAX collect phase's draws (``Trainer._collect``), in the port's
    order, and the state's next rng."""
    E = tcfg.num_envs
    draws = []
    rng, scan_key = jax.random.split(rng)
    for key in jax.random.split(scan_key, tcfg.stride):
        k_noise, k_env = jax.random.split(key)
        draws.append(jax.random.normal(k_noise, (E, action_dim), jnp.float32))
        k12 = jax.vmap(jax.random.split)(jax.random.split(k_env, E))
        draws.append(jax.vmap(
            lambda k: jax.random.uniform(k, (), minval=-jnp.pi, maxval=jnp.pi)
        )(k12[:, 0]))
        draws.append(jax.vmap(
            lambda k: jax.random.uniform(k, (), minval=-1.0, maxval=1.0)
        )(k12[:, 1]))
    return [torch.tensor(np.asarray(x)) for x in draws], rng


@pytest.fixture(scope="module")
def actor_pair():
    """A JAX and a port actor (id 1 of 2) on the same state, params v1."""
    from r2d2dpg_tpu.fleet.actor import FleetActor as JFleetActor

    ja = JFleetActor(J_TINY, actor_id=1, num_actors=2, address="127.0.0.1:1", seed=0)
    jt = ja.trainer
    host = jax.device_get(jt.init(jax.random.fold_in(jax.random.PRNGKey(0), 1)))
    snap = {f: jax.tree_util.tree_map(lambda x: np.asarray(x) * 1.01,
                                      getattr(host.train, f)) for f in PARAM_FIELDS}
    assert ja.maybe_apply_params({"version": 1, "params": snap})
    pa = FleetActor(PENDULUM_TINY, actor_id=1, num_actors=2, address="127.0.0.1:1",
                    seed=0, device="cpu")
    n_phases = jt.window_fill_phases + 3
    rng, draws = ja._cstate.rng, []  # the collector's fork of the state's key
    for _ in range(n_phases):
        d, rng = _collect_draws(rng, jt.config, jt.env.spec.action_dim)
        draws += d
    replay = ReplayDraws(draws)
    ts = trainer_state_from_jax(host, replay, device="cpu")
    pa._cstate = CollectorState(**{f: getattr(ts, f) for f in _COLLECT_FIELDS})
    pa._train = ts.train
    port_snap = {f: {k: v.numpy() for k, v in net_params_from_flax(snap[f]).items()}
                 for f in PARAM_FIELDS}
    assert pa.maybe_apply_params({"version": 1, "params": port_snap})
    out = []
    for _ in range(n_phases):
        out.append((jax.device_get(ja.collect_phase()), pa.collect_phase()))
    return ja, pa, out, replay


def test_actor_collect_consumes_exactly_the_jax_draws(actor_pair):
    *_, replay = actor_pair
    assert replay.remaining() == 0


def test_actor_collect_phases_match_jax(actor_pair):
    ja, pa, out, _ = actor_pair
    emitted = 0
    for j, p in out:
        assert (j is None) == (p is None)
        if j is None:
            continue
        emitted += 1
        for name in ("obs", "action", "reward", "discount", "reset"):
            np.testing.assert_allclose(getattr(p.seq, name).numpy(),
                                       np.asarray(getattr(j.seq, name)), **TOL,
                                       err_msg=name)
        for net in ("actor", "critic"):
            for x, y in zip(p.seq.carries[net], j.seq.carries[net], strict=True):
                np.testing.assert_allclose(x.numpy(), np.asarray(y), **TOL)
        np.testing.assert_allclose(p.priorities.numpy(), np.asarray(j.priorities), **TOL)
    assert emitted == 3 and pa._phase == ja._phase
    np.testing.assert_allclose(pa._cstate.obs.numpy(), np.asarray(ja._cstate.obs), **TOL)
    assert pa._cstate.env_steps == int(ja._cstate.env_steps)
    np.testing.assert_allclose(pa._cstate.episode_return.numpy(),
                               np.asarray(ja._cstate.episode_return), **TOL)


def test_param_version_regressions_ignored():
    actor = FleetActor(PENDULUM_TINY, actor_id=0, num_actors=2,
                       address="127.0.0.1:1", seed=0, device="cpu")

    def snap(version):
        tr = actor._train
        return {"version": version, "params": {
            f: {k: v.numpy() * (1.0 + version if f == "actor_params" else 1.0)
                for k, v in getattr(tr, f).items()} for f in PARAM_FIELDS}}

    assert actor.maybe_apply_params(snap(2)) and actor._param_version == 2
    after = {k: v.clone() for k, v in actor._train.actor_params.items()}
    assert not actor.maybe_apply_params(snap(1))
    assert not actor.maybe_apply_params(snap(2))
    for k, v in after.items():
        assert torch.equal(actor._train.actor_params[k], v)
    assert actor.maybe_apply_params(snap(3)) and actor._param_version == 3


def test_host_batch_stamps_provenance_and_episode_deltas():
    actor = FleetActor(PENDULUM_TINY, actor_id=0, num_actors=1,
                       address="127.0.0.1:1", seed=0, device="cpu")
    batches = [actor.host_batch() for _ in range(actor.trainer.window_fill_phases + 2)]
    assert all(b is None for b in batches[:actor.trainer.window_fill_phases])
    b = batches[-1]
    e = PENDULUM_TINY.trainer.num_envs
    # One device-to-host copy: every leaf is a view of one host buffer.
    assert isinstance(b.seq.obs, np.ndarray)
    assert b.seq.obs.base is b.priorities.base
    np.testing.assert_array_equal(b.behavior_version, np.zeros(e, np.int64))
    np.testing.assert_array_equal(b.collect_id, np.full(e, actor._phase, np.int64))
    assert b.priorities.shape == (e,)
    assert actor._pending_stats["env_steps_delta"] == float(actor._cstate.env_steps)


# -------------------------------------------------- actors=0 is Trainer.run
def test_actors_0_bitwise_equals_trainer_run():
    from r2d2dpg_torch.train import main

    t = PENDULUM_TINY.build("cpu")
    ref = t.run(t.window_fill_phases + t.replay_fill_phases + N_TRAIN,
                log_every=3, log_fn=lambda *_: None)
    got = main(["--config", "pendulum_tiny", "--actors", "0", "--phases",
                str(N_TRAIN), "--log-every", "3", "--device", "cpu", "--watchdog", "0"])
    _assert_states_bitwise(ref, got)


# ------------------------------------------------------------ ingest server
def _hello(sock, actor_id=3, cfg=None):
    send_frame(sock, K_HELLO, pack_hello(
        {"actor_id": actor_id, **wire.negotiation_fields(cfg or wire.WireConfig())}))


def _seqs(packer, phase):
    return packer.pack({"phase": phase, "param_version": 0, "env_steps_delta": 12.0,
                        "ep_return_sum": 0.0, "ep_count": 0.0, "staged": _np_staged()})


def test_ingest_ack_shed_and_param_push():
    q = queue.Queue(maxsize=1)
    srv = IngestServer(q, shed_after_s=0.05, startup_shed_grace_s=0.05).start()
    try:
        sock = transport.connect(srv.address)
        sock.settimeout(10)
        packer, unpacker = wire.TreePacker(wire.WireConfig()), wire.TreeUnpacker()
        _hello(sock)
        kind, payload = recv_frame(sock)
        assert kind == K_ACK and unpack_obj(payload) == {"code": OK, "param_version": 0}
        send_frame_parts(sock, K_SEQS, _seqs(packer, 1))
        kind, payload = recv_frame(sock)
        assert unpack_obj(payload)["code"] == OK and q.qsize() == 1
        msg = q.queue[0]
        assert msg["actor_id"] == "3" and msg["env_steps_delta"] == 12.0
        assert isinstance(msg["staged"], StagedSequences)
        assert "3" in srv.first_seqs_at
        send_frame_parts(sock, K_SEQS, _seqs(packer, 2))  # queue full: shed
        kind, payload = recv_frame(sock)
        assert unpack_obj(payload)["code"] == SHED_INGEST and srv.shed_total == 1
        assert any(e["kind"] == "shed" and e.get("actor") == "3"
                   for e in get_flight_recorder().events())
        assert srv.pop_shed_stats()["env_steps_delta"] == 12.0
        assert srv.pop_shed_stats()["env_steps_delta"] == 0.0
        srv.publish_params(1, {"w": np.arange(3.0, dtype=np.float32)})
        send_frame_parts(sock, K_SEQS, _seqs(packer, 3))
        kind, payload = recv_frame(sock)
        assert kind == K_PARAMS
        params = unpacker.unpack(payload)
        assert params["version"] == 1
        np.testing.assert_array_equal(params["params"]["w"], np.arange(3.0))
        kind, payload = recv_frame(sock)
        assert kind == K_ACK and unpack_obj(payload)["param_version"] == 1
        sock.close()
    finally:
        srv.stop()


@pytest.mark.parametrize("hello, reason", [
    ({"actor_id": 0, **wire.negotiation_fields(wire.WireConfig())}, "encoding"),
    ({"actor_id": 1}, "wire_version"),
], ids=["encoding", "version"])
def test_ingest_refuses_wire_mismatch(hello, reason):
    q = queue.Queue(maxsize=1)
    srv = IngestServer(q, wire_config=wire.WireConfig(encoding="bf16")).start()
    try:
        sock = transport.connect(srv.address)
        sock.settimeout(10)
        send_frame(sock, K_HELLO, pack_hello(hello))
        kind, payload = recv_frame(sock)
        ack = unpack_obj(payload)
        assert kind == K_ACK and ack["code"] == REFUSED_WIRE
        assert reason in ack["reason"] and ack["expect"]["encoding"] == "bf16"
        with pytest.raises(transport.FrameTruncated):
            recv_frame(sock)
        sock.close()
        assert q.qsize() == 0
    finally:
        srv.stop()


def test_ingest_auth_refusal_and_acceptance():
    q = queue.Queue(maxsize=2)
    srv = IngestServer(q, auth_token="s3cret").start()
    try:
        for token, code in ((None, "refused_auth"), ("wrong", "refused_auth"),
                            ("s3cret", OK)):
            sock = transport.connect(srv.address)
            sock.settimeout(10)
            hello = {"actor_id": 0, **wire.negotiation_fields(wire.WireConfig())}
            if token is not None:
                hello["auth"] = transport.hello_auth_proof(token)
            send_frame(sock, K_HELLO, pack_hello(hello))
            kind, payload = recv_frame(sock)
            assert kind == K_ACK and unpack_obj(payload)["code"] == code
            sock.close()
    finally:
        srv.stop()


def test_ingest_stop_interrupts_startup_grace_wait():
    q = queue.Queue(maxsize=1)
    srv = IngestServer(q, shed_after_s=60.0, startup_shed_grace_s=60.0).start()
    sock = transport.connect(srv.address)
    sock.settimeout(10)
    packer = wire.TreePacker(wire.WireConfig())
    _hello(sock, 0)
    recv_frame(sock)
    send_frame_parts(sock, K_SEQS, _seqs(packer, 1))
    recv_frame(sock)
    send_frame_parts(sock, K_SEQS, _seqs(packer, 2))  # parks in the graced put
    time.sleep(0.5)
    t0 = time.monotonic()
    srv.stop()
    assert time.monotonic() - t0 < 10
    sock.close()


def test_drop_connection_reaches_the_handler():
    q = queue.Queue(maxsize=1)
    srv = IngestServer(q).start()
    try:
        sock = transport.connect(srv.address)
        sock.settimeout(10)
        _hello(sock, 5)
        recv_frame(sock)
        assert srv.drop_connection("5") == "5"
        with pytest.raises((transport.FrameError, OSError)):
            recv_frame(sock)
        sock.close()
        _wait(lambda: not srv._conns, 10)
        assert srv.drop_connection() is None
    finally:
        srv.stop()


# --------------------------------------------------------------- put_staged
@pytest.mark.parametrize("provenance", [False, True], ids=["plain", "provenance"])
def test_put_staged_equals_stack_staged(provenance):
    """Host stacking into one buffer: the same tensors as stacking the
    batches as tensors, from read-only decoded views, without a warning."""
    import warnings

    frames = [wire.TreeUnpacker().unpack(b"".join(wire.TreePacker(
        wire.WireConfig()).pack({"s": _np_staged(b=2 + i, seed=i, provenance=provenance)})))["s"]
        for i in range(3)]
    assert not frames[0].seq.obs.flags.writeable
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = put_staged(frames, "cpu")
    as_tensors = [dataclasses.replace(
        f, seq=SequenceBatch(**{
            k.name: (torch.tensor(getattr(f.seq, k.name)) if k.name != "carries" else
                     {"actor": tuple(torch.tensor(x) for x in f.seq.carries["actor"])})
            for k in dataclasses.fields(SequenceBatch)}),
        priorities=torch.tensor(f.priorities),
        behavior_version=None if f.behavior_version is None else torch.tensor(f.behavior_version),
        collect_id=None if f.collect_id is None else torch.tensor(f.collect_id))
        for f in frames]
    want = stack_staged(as_tensors)
    from r2d2dpg_torch.tree import tree_leaves

    lg, lw = tree_leaves(got), tree_leaves(want)
    assert len(lg) == len(lw) == (10 if provenance else 8)
    for x, y in zip(lg, lw):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_put_staged_refusals_and_partial_provenance():
    with pytest.raises(ValueError, match="mix"):
        put_staged([_np_staged(), _np_staged(priorities=False)], "cpu")
    with pytest.raises(ValueError, match="at least one"):
        put_staged([], "cpu")
    out = put_staged([_np_staged(provenance=True), _np_staged()], "cpu")
    assert out.behavior_version is None and out.collect_id is None
    out = put_staged([_np_staged(priorities=False)], "cpu")
    assert out.priorities is None


def test_snapshot_params_copies():
    t = PENDULUM_TINY.build("cpu")
    train = t.agent.init(torch.Generator().manual_seed(0), torch.device("cpu"))
    snap = snapshot_params(train)
    assert snap["step"] == train.step
    for f in PARAM_FIELDS:
        for k, v in getattr(train, f).items():
            np.testing.assert_array_equal(snap[f][k], v.numpy())
            assert not np.shares_memory(snap[f][k], v.numpy())
    k0 = next(iter(train.actor_params))
    before = snap["actor_params"][k0].copy()
    train.actor_params[k0].add_(1.0)
    np.testing.assert_array_equal(snap["actor_params"][k0], before)


# ---------------------------------------------- learner + thread actor(s)
def _drain_with_thread_actors(n_actors, wcfg, coalesce, spy=False, trace=0.0):
    trainer = PENDULUM_TINY.build("cpu")
    seen = {"agent": set()}
    if spy:
        for m in (trainer.agent.actor, trainer.agent.critic):
            plain = m.apply_params

            def apply_params(*args, _plain=plain):
                seen["agent"].add(threading.current_thread().name)
                return _plain(*args)

            m.apply_params = apply_params
    learner = FleetLearner(trainer, FleetConfig(
        num_actors=n_actors, queue_depth=4, idle_timeout_s=60, wire=wcfg,
        drain_coalesce=coalesce))
    address = learner.start()
    actors = [FleetActor(PENDULUM_TINY, actor_id=i, num_actors=n_actors,
                         address=address, seed=0, wire_config=wcfg, device="cpu",
                         trace_sample=trace)
              for i in range(n_actors)]
    threads = [threading.Thread(target=_swallow, args=(a.run, 400),
                                name=f"thread-actor{i}", daemon=True)
               for i, a in enumerate(actors)]
    for th in threads:
        th.start()
    logged = []
    try:
        state = learner.run(N_TRAIN, log_every=3,
                            metrics_fn=lambda p, s: logged.append((p, s)))
    finally:
        learner.close()
        for th in threads:
            th.join(timeout=30)
    return trainer, learner, state, logged, seen


@pytest.mark.parametrize("lane", ["f32", "bf16_zlib_coalesced"])
def test_fleet_learner_drains_thread_actors(lane):
    if lane == "f32":
        wcfg, n_actors, coalesce = wire.WireConfig(), 1, 1
    else:
        wcfg, n_actors, coalesce = wire.WireConfig(encoding="bf16", compress="zlib"), 2, 2
    trainer, learner, state, logged, _ = _drain_with_thread_actors(
        n_actors, wcfg, coalesce)
    tc = trainer.config
    stats = learner.stats()
    assert state.train.step == N_TRAIN * tc.learner_steps
    assert stats["train_phases"] == N_TRAIN
    assert trainer.arena.size(state.arena) == int(stats["absorbed_seqs"])
    assert stats["absorbed_seqs"] >= tc.min_replay + N_TRAIN * tc.num_envs
    assert [p for p, _ in logged] == [3, 6]
    for _, scalars in logged:
        assert np.isfinite(scalars["critic_loss"]) and scalars["learner_steps"] > 0
    assert torch.isfinite(state.arena.priority).all()
    assert stats["quality_lag_mean"] >= 0  # provenance stamped and folded
    if lane == "f32":
        assert 0.95 < stats["wire_ratio"] <= 1.0
    else:
        assert stats["wire_ratio"] > 1.0 and 0 < stats["bytes_per_seq"] < 2000
        assert 1.0 <= stats["drain_coalesce_width_mean"] <= 2.0


def test_traced_batches_record_the_eight_wire_hops():
    from r2d2dpg_torch.obs.trace import WIRE_HOPS

    rec = get_flight_recorder()
    rec.clear_spans()
    _drain_with_thread_actors(1, wire.WireConfig(), 1, trace=1.0)
    spans = rec.spans()
    by_trace = {}
    for sp in spans:
        by_trace.setdefault(sp["trace_id"], set()).add(sp["hop"])
    # Every trained batch is traced, with all 8 hops; absorbed ones are not.
    assert len(by_trace) >= N_TRAIN
    assert all(hops == set(WIRE_HOPS) for hops in by_trace.values())
    rec.clear_spans()


def test_no_handler_or_actor_thread_runs_the_learner_modules():
    """``functional_call`` swaps a module's parameters for a call, so only
    the learner's thread may run the learner's modules: ingest handlers
    and the (thread) actor never touch them."""
    *_, seen = _drain_with_thread_actors(1, wire.WireConfig(), 1, spy=True)
    assert seen["agent"] == {threading.main_thread().name}


def test_fleet_learner_rejections():
    trainer = PENDULUM_TINY.build("cpu")
    for cfg, match in ((FleetConfig(num_actors=0), "num_actors"),
                       (FleetConfig(num_actors=1, queue_depth=0), "queue_depth"),
                       (FleetConfig(num_actors=1, drain_coalesce=0), "drain_coalesce"),
                       (FleetConfig(num_actors=1, wire=wire.WireConfig(encoding="f16")),
                        "encoding")):
        with pytest.raises(ValueError, match=match):
            FleetLearner(trainer, cfg)
    with pytest.raises(ValueError, match="shard_map"):
        FleetLearner(types.SimpleNamespace(axis="dp"), FleetConfig(num_actors=1))


def test_health_fn_aborts_the_run():
    learner = FleetLearner(PENDULUM_TINY.build("cpu"), FleetConfig(num_actors=1))
    learner.start()

    def health():
        raise RuntimeError("gave up actor(s) [0]")

    try:
        with pytest.raises(RuntimeError, match="gave up"):
            learner.run(1, health_fn=health)
    finally:
        learner.close()


# ------------------------------------------------ checkpoints and resume
def test_fleet_counters_sidecar_roundtrip_and_prune(tmp_path):
    d = str(tmp_path)
    counters = {"drained": 6, "env_steps_total": 1234.0, "param_version": 7,
                "ep_return_sum": -3.25, "ep_count": 2, "episodes_total": 11}
    save_fleet_counters(d, 6, counters)
    save_fleet_counters(d, 4, {"drained": 4})
    assert load_fleet_counters(d, 6) == {k: float(v) for k, v in counters.items()}
    assert load_fleet_counters(d, 99) == {}
    prune_fleet_counters(d, keep_steps=[6])
    assert load_fleet_counters(d, 4) == {} and load_fleet_counters(d, 6)["drained"] == 6.0


def test_fleet_learner_checkpoint_resume_in_process(tmp_path):
    """Run 4 drain phases with checkpoints every 2, then a FRESH learner
    resumes from the light checkpoint and its sidecar: it re-absorbs to
    min_replay, completes the TOTAL of 6, and every counter continues."""
    ckpt_dir = str(tmp_path / "ckpt")

    def fleet_run(n_total, resume):
        trainer = PENDULUM_TINY.build("cpu")
        learner = FleetLearner(trainer, FleetConfig(num_actors=1, queue_depth=8,
                                                    idle_timeout_s=120))
        address = learner.start()
        actor = FleetActor(PENDULUM_TINY, actor_id=0, num_actors=1,
                           address=address, seed=0, device="cpu")
        th = threading.Thread(target=_swallow, args=(actor.run, 400), daemon=True)
        th.start()
        ckpt = CheckpointManager(ckpt_dir, save_every=2, light=True)
        state, resume_from = None, None
        if resume:
            state = trainer.init()
            state = dataclasses.replace(state, train=ckpt.restore(state))
            resume_from = load_fleet_counters(ckpt_dir, ckpt.latest_step)
        try:
            state = learner.run(n_total, state=state, log_every=0, ckpt=ckpt,
                                checkpoint_every=2, resume_from=resume_from)
        finally:
            learner.close()
            th.join(timeout=30)
        return trainer, learner, state

    t1, l1, s1 = fleet_run(4, resume=False)
    assert l1.counters()["drained"] == 4 and s1.train.step == 4
    saved = load_fleet_counters(ckpt_dir, 4)
    assert saved["drained"] == 4 and saved["env_steps_total"] > 0
    t2, l2, s2 = fleet_run(6, resume=True)
    c2 = l2.counters()
    assert c2["drained"] == 6 and s2.train.step == 6
    assert c2["env_steps_total"] > saved["env_steps_total"]
    assert c2["param_version"] > saved["param_version"]
    assert l2.stats()["train_phases"] == 2 and l2.stats()["train_phases_total"] == 6


# --------------------------------------------------------------- supervisor
class _FakeProc:
    def __init__(self, returncode=None):
        self.returncode = returncode

    def poll(self):
        return self.returncode


def _fake_supervisor(cls, cfg_cls, **cfg):
    sup = cls(lambda i: ["unused"], 1, config=cfg_cls(**cfg), clock=lambda: 0.0)
    spawned = []

    def fake_spawn(actor_id):
        slot = sup._slots[actor_id]
        slot.proc = _FakeProc()
        slot.restart_at = None
        spawned.append(actor_id)

    sup._spawn = fake_spawn
    return sup, spawned


SCHEDULES = {
    # name: (config, [(time, crash rc or None, started_at or None)])
    "deadline": (dict(backoff_base_s=0.5),
                 [(100.0, 1, 90.0), (100.49, None, None), (100.5, None, None)]),
    "doubles_and_caps": (dict(backoff_base_s=0.5, backoff_max_s=2.0),
                         [(100.0, 1, None), (100.5, None, None), (101.5, 1, None),
                          (102.5, None, None), (103.5, 1, None), (105.5, None, None),
                          (106.5, 1, None), (108.5, None, None)]),
    "healthy_reset": (dict(backoff_base_s=0.5, backoff_max_s=30.0, healthy_after_s=60.0),
                      [(10.0, 1, 0.0), (10.5, None, None), (12.0, None, 11.0),
                       (72.0, None, None), (80.0, 1, None), (80.5, None, None)]),
    "max_restarts": (dict(backoff_base_s=0.5, max_restarts=1),
                     [(10.0, 1, 0.0), (10.5, None, None), (20.0, 1, None),
                      (100.0, None, None)]),
    "terminal_exit": (dict(backoff_base_s=0.5),
                      [(10.0, EXIT_WIRE_REFUSED, 0.0), (20.0, None, None)]),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_supervisor_fake_clock_schedule_equals_jax(name):
    from r2d2dpg_tpu.fleet.supervisor import ActorSupervisor as JSup
    from r2d2dpg_tpu.fleet.supervisor import SupervisorConfig as JCfg

    cfg, steps = SCHEDULES[name]
    trace = {}
    for label, cls, cfg_cls in (("jax", JSup, JCfg), ("port", ActorSupervisor,
                                                       SupervisorConfig)):
        sup, spawned = _fake_supervisor(cls, cfg_cls, **cfg)
        slot = sup._slots[0]
        slot.proc = _FakeProc()
        rows = []
        for now, rc, started in steps:
            if rc is not None:
                slot.proc = _FakeProc(returncode=rc)
            if started is not None:
                slot.started_at = started
            sup._poll_once(now)
            rows.append((slot.restart_at, slot.consecutive_crashes, slot.restarts,
                         slot.gave_up, len(spawned)))
        trace[label] = rows
    assert trace["port"] == trace["jax"]


def _real_supervisor(code, **cfg):
    return ActorSupervisor(lambda i: [sys.executable, "-c", code], 1,
                           config=SupervisorConfig(poll_s=0.02, **cfg))


def _wait(pred, seconds=20):
    deadline = time.monotonic() + seconds
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.05)


def test_supervisor_restarts_crashes_with_backoff():
    sup = _real_supervisor("import time; time.sleep(0.05); exit(3)",
                           backoff_base_s=0.05, backoff_max_s=0.2)
    sup.start()
    try:
        _wait(lambda: sup.restarts_total >= 2)
    finally:
        sup.stop()
    assert sup.restarts_total >= 2 and not sup.gave_up()
    assert any(e["kind"] == "actor_crash" and e.get("returncode") == 3
               for e in get_flight_recorder().events())


@pytest.mark.parametrize("code, restarts", [
    ("exit(1)", 1), (f"exit({EXIT_WIRE_REFUSED})", 0),
], ids=["budget", "wire_refused"])
def test_supervisor_gives_up(code, restarts):
    sup = _real_supervisor(code, backoff_base_s=0.02, max_restarts=1)
    sup.start()
    try:
        _wait(lambda: sup.gave_up())
    finally:
        sup.stop()
    assert sup.gave_up() == [0] and sup.restarts_total == restarts


def test_spawned_children_see_no_card():
    """The child environment hides every card and the actor argv runs
    the port's actor on the CPU."""
    sup = ActorSupervisor(lambda i: [sys.executable, "-c", "pass"], 1,
                          env={"CUDA_VISIBLE_DEVICES": "0", "PATH": os.environ["PATH"]})
    assert sup._env["CUDA_VISIBLE_DEVICES"] == ""
    assert "JAX_PLATFORMS" not in sup._env
    argv = default_actor_argv(2, config_name="pendulum_r2d2", address="127.0.0.1:9",
                              num_actors=3, seed=5, extra=["--wire", "bf16"])
    assert argv[1:5] == ["-m", "r2d2dpg_torch.fleet.actor", "--device", "cpu"]
    assert argv[argv.index("--actor-id") + 1] == "2"
    assert argv[-2:] == ["--wire", "bf16"]


def test_train_cli_spawner_argv_and_env(monkeypatch):
    """What the CLI hands the supervisor: the resolved structure, the wire
    lane, the heartbeat and --device cpu in argv; the token only in the
    environment."""
    import r2d2dpg_torch.fleet as fleet_pkg
    from r2d2dpg_torch.train import main

    captured = {}

    class Stop(Exception):
        pass

    class FakeSupervisor:
        def __init__(self, argv_fn, n, *, env=None, log_path_fn=None, **kw):
            captured.update(argv=argv_fn(1), n=n, env=env)

        def start(self):
            raise Stop

        def stop(self):
            pass

    monkeypatch.setattr(fleet_pkg, "ActorSupervisor", FakeSupervisor)
    with pytest.raises(Stop):
        main(["--config", "pendulum_tiny", "--actors", "2", "--device", "cpu",
              "--num-envs", "3", "--sigma-max", "0.7", "--fleet-wire", "bf16",
              "--fleet-token", "s3cret", "--fleet-heartbeat", "9"])
    argv = captured["argv"]
    assert captured["n"] == 2
    assert argv[1:5] == ["-m", "r2d2dpg_torch.fleet.actor", "--device", "cpu"]
    assert argv[argv.index("--num-envs") + 1] == "3"
    assert argv[argv.index("--sigma-max") + 1] == "0.7"
    assert argv[argv.index("--wire") + 1] == "bf16"
    assert argv[argv.index("--read-deadline") + 1] == "9.0"
    assert "s3cret" not in " ".join(argv)
    assert captured["env"]["R2D2DPG_FLEET_TOKEN"] == "s3cret"


def test_structural_argv_equals_jax():
    from r2d2dpg_tpu.configs import CONFIGS as J_CONFIGS
    from r2d2dpg_tpu.fleet.actor import structural_argv as j_structural
    from r2d2dpg_torch.configs import CONFIGS

    for name in CONFIGS:
        assert structural_argv(CONFIGS[name]) == j_structural(J_CONFIGS[name])


@pytest.mark.parametrize("flag", ["--telem-every"])
def test_actor_parser_refuses_unported_flags(flag):
    """The actor parser refuses what JAX's refuses: ``--telem-every``, once
    unported, now parses to JAX's value, and a flag neither has is refused
    by both."""
    from r2d2dpg_tpu.fleet.actor import parse_args as j_parse
    from r2d2dpg_torch.fleet.actor import parse_args

    base = ["--config", "pendulum_tiny", "--connect", "x:1", "--actor-id", "0",
            "--num-actors", "1"]
    dest = flag.lstrip("-").replace("-", "_")
    assert getattr(parse_args([*base, flag, "1"]), dest) == getattr(
        j_parse([*base, flag, "1"]), dest) == 1.0
    for parse in (parse_args, j_parse):
        with pytest.raises(SystemExit):
            parse([*base, "--no-such-flag", "1"])


def test_actor_overrides_equal_jax():
    from r2d2dpg_tpu.configs import CONFIGS as J_CONFIGS
    from r2d2dpg_tpu.fleet.actor import _apply_overrides as j_apply
    from r2d2dpg_tpu.fleet.actor import parse_args as j_parse
    from r2d2dpg_torch.configs import get_config
    from r2d2dpg_torch.fleet.actor import _apply_overrides, parse_args

    argv = ["--config", "pendulum_r2d2", "--connect", "x:1", "--actor-id", "0",
            "--num-actors", "2", "--seed", "4", *structural_argv(get_config("walker_r2d2"))]
    port = _apply_overrides(get_config("pendulum_r2d2"), parse_args(argv))
    ref = j_apply(J_CONFIGS["pendulum_r2d2"], j_parse(argv))
    for part in ("agent", "trainer"):
        for f in dataclasses.fields(getattr(port, part)):
            assert getattr(getattr(port, part), f.name) == getattr(getattr(ref, part), f.name)
    assert port.compute_dtype == ref.compute_dtype


# ------------------------------------------------------------- CLI refusals
COMPOSE = [["--pipeline", "1"], ["--eval-every", "5"], ["--nan-inject-phase", "1"]]
WIRE_FLAGS = [["--fleet-wire", "bf16"], ["--fleet-compress", "zlib"],
              ["--drain-coalesce", "4"], ["--fleet-token", "s3cret"],
              ["--fleet-heartbeat", "5"], ["--fleet-shed-after", "5"]]


def _jax_refusal(argv):
    from r2d2dpg_tpu import train as jtrain

    with pytest.raises(SystemExit) as e:
        jtrain.run(jtrain.parse_args(argv))
    return str(e.value)


def _port_refusal(argv):
    from r2d2dpg_torch.train import main

    with pytest.raises(SystemExit) as e:
        main([*argv, "--device", "cpu"])
    return str(e.value)


@pytest.mark.parametrize("flags", COMPOSE, ids=lambda f: f[0])
def test_cli_refuses_fleet_combos_as_jax(flags):
    argv = ["--config", "pendulum_tiny", "--actors", "2", *flags]
    want = _jax_refusal(argv)
    assert "does not compose" in want
    assert _port_refusal(argv) == want


@pytest.mark.parametrize("flags", WIRE_FLAGS, ids=lambda f: f[0])
def test_cli_refuses_wire_flags_without_actors(flags):
    argv = ["--config", "pendulum_tiny", *flags]
    assert "require --actors" in _jax_refusal(argv)
    assert "require --actors" in _port_refusal(argv)


@pytest.mark.parametrize("argv, match", [
    (["--trace-sample", "0.5"], "requires --actors N or --pipeline"),
    (["--actors", "1", "--fleet-heartbeat", "0"], "must be > 0"),
    (["--actors", "1", "--trace-sample", "2"], r"in \[0, 1\]"),
], ids=["trace_without_staging", "heartbeat", "trace_range"])
def test_cli_value_refusals_equal_jax(argv, match):
    argv = ["--config", "pendulum_tiny", *argv]
    want = _jax_refusal(argv)
    assert _port_refusal(argv) == want
    assert re.search(match, want)


def test_cli_refuses_unavailable_zstd(monkeypatch):
    """Where ``zstandard`` is missing, ``--fleet-compress zstd`` is refused
    at startup (the module is hidden here to show it either way)."""
    from r2d2dpg_torch.fleet import wire as pw

    monkeypatch.setattr(pw, "_zstd", None)
    msg = _port_refusal(["--config", "pendulum_tiny", "--actors", "1",
                         "--fleet-compress", "zstd"])
    assert msg.startswith("--fleet-compress:") and "not available" in msg


def test_ingest_handoffs_take_queue_room_in_arrival_order():
    """Handlers waiting on a full queue get its room first come, first
    served, however their waits' slices fall (``_put_or_shed``), and one
    whose wait passes ``shed_after_s`` sheds with a ``put_wait`` event."""
    q = queue.Queue(maxsize=1)
    q.put({"actor_id": "filler"})
    srv = IngestServer(q, shed_after_s=5.0, startup_shed_grace_s=5.0)
    srv.mark_steady()
    done = []
    threads = [threading.Thread(target=lambda i=i: done.append(
        (i, srv._put_or_shed({"actor_id": str(i)})))) for i in range(3)]
    for t in threads:  # arrivals 0.3 s apart: each slice (0.25 s) ends first
        t.start()
        time.sleep(0.3)
    order = []
    for _ in range(4):
        order.append(q.get(timeout=10)["actor_id"])
        time.sleep(0.3)
    for t in threads:
        t.join(timeout=10)
    assert order == ["filler", "0", "1", "2"]
    assert sorted(done) == [(0, True), (1, True), (2, True)] and not srv._tickets
    # Room freed for a waiting handler goes to it, not to a handler that
    # arrives as it frees (here on this very thread, holding the GIL).
    srv.shed_after_s = 1.0
    q.put({"actor_id": "filler"})
    waiter = threading.Thread(target=lambda: done.append(
        ("old", srv._put_or_shed({"actor_id": "old"}))))
    waiter.start()
    time.sleep(0.4)
    assert q.get(timeout=5)["actor_id"] == "filler"
    late = srv._put_or_shed({"actor_id": "new"})
    waiter.join(timeout=10)
    assert q.get(timeout=5)["actor_id"] == "old"
    assert ("old", True) in done and late is False
    # A wait past the bound sheds, recorded as a long hand-off.
    srv.shed_after_s = 0.6
    get_flight_recorder().clear()
    q.put({"actor_id": "filler"})
    assert srv._put_or_shed({"actor_id": "7"}) is False
    waits = [e for e in get_flight_recorder().events() if e["kind"] == "put_wait"]
    assert waits and waits[-1]["shed"] and waits[-1]["actor"] == "7"


def test_stall_clock_records_long_drain_iterations():
    """A drain-learn iteration of ``STALL_EVENT_S`` or more is one
    ``drain_stall`` event with its segments, CPU and sampled stacks;
    ``close`` sums every iteration into ``drain_clock``."""
    from r2d2dpg_torch.fleet.ingest import STALL_EVENT_S, _StallClock

    get_flight_recorder().clear()
    clock = _StallClock()
    clock.begin()
    clock.mark("pack")
    clock.end(drained=1)  # short: no event
    clock.begin()
    time.sleep(STALL_EVENT_S + 0.1)
    clock.mark("learn")
    clock.end(drained=2, width=4)
    clock.close()
    events = get_flight_recorder().events()
    (stall,) = [e for e in events if e["kind"] == "drain_stall"]
    assert stall["drained"] == 2 and stall["width"] == 4
    assert stall["wall_s"] >= STALL_EVENT_S and stall["segments_ms"]["learn"] >= 500
    assert stall["thread_cpu_ms"] < 200  # asleep, not computing
    assert any("time.sleep" in where or "test_torch_fleet.py" in where
               for where, _ in stall["stack"])
    (total,) = [e for e in events if e["kind"] == "drain_clock"]
    assert total["iterations"] == 2 and total["wall_s"] >= STALL_EVENT_S


# -------------------------------------------------- CLI with real actors
@pytest.mark.parametrize("flags", [(), ("--fleet-wire", "bf16", "--fleet-compress",
                                        "zlib", "--drain-coalesce", "2")],
                         ids=["f32", "bf16_zlib"])
def test_train_cli_with_actor_subprocesses(tmp_path, capsys, flags, monkeypatch):
    """Both actors stream into a short CLI run.

    The run ends after 5 staged batches, which one actor alone supplies
    within ~0.5 s of its first; under a loaded test host one actor's start
    (importing torch) can lag the other's by more than that, and the run
    then ended before the late actor's first SEQS.  So the learner's run
    starts once both handlers have read a SEQS frame (bounded: a missing
    actor still fails the assertion below); the run itself is unchanged."""
    from r2d2dpg_torch.train import main

    plain_run = FleetLearner.run

    def run_when_both_stream(self, *args, **kwargs):
        deadline = time.monotonic() + 120.0
        while len(self.server.first_seqs_at) < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        return plain_run(self, *args, **kwargs)

    monkeypatch.setattr(FleetLearner, "run", run_when_both_stream)
    state = main(["--config", "pendulum_tiny", "--actors", "2", "--phases", "3",
                  "--device", "cpu", "--log-every", "1", "--logdir", str(tmp_path),
                  "--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "2",
                  *flags])
    out = capsys.readouterr().out
    assert state.train.step == 3
    stats_line = next(x for x in out.splitlines()
                      if x.startswith("fleet: ") and "wall_s" in x)
    words = stats_line.split()[1:]
    stats = dict(zip(words[::2], map(float, words[1::2])))
    assert stats["train_phases"] == 3 and stats["actor_restarts"] == 0
    assert "actor0_first_seqs_s" in stats and "actor1_first_seqs_s" in stats
    assert len([x for x in out.splitlines() if x.startswith("phase ")]) == 3
    assert "always light" in out
    assert load_fleet_counters(str(tmp_path / "ck"), 2)["drained"] == 2.0
    assert os.path.exists(tmp_path / "metrics.csv")


@pytest.mark.slow
def test_fleet_soak_kill_one_actor_supervised_restart(tmp_path):
    """Three real actor subprocesses; one is killed mid-run: the supervisor
    restarts it and the run completes its phase count."""
    trainer = PENDULUM_TINY.build("cpu")
    learner = FleetLearner(trainer, FleetConfig(num_actors=3, queue_depth=4,
                                                idle_timeout_s=600))
    address = learner.start()
    sup = ActorSupervisor(
        lambda i: default_actor_argv(i, config_name="pendulum_tiny", address=address,
                                     num_actors=3, seed=0),
        3, config=SupervisorConfig(backoff_base_s=0.2),
        log_path_fn=lambda i: str(tmp_path / f"actor{i}.log"))
    killed = []

    def metrics_fn(phase, scalars):
        if phase >= 2 and not killed:
            killed.append(sup.kill_actor(0))

    try:
        sup.start()
        state = learner.run(24, log_every=2, metrics_fn=metrics_fn)
    finally:
        sup.stop()
        learner.close()
    assert killed == [True] and state.train.step == 24
    assert sup.restarts_total >= 1
    dump = str(tmp_path / "flight.jsonl")
    get_flight_recorder().dump(dump)
    with open(dump) as f:
        events = [json.loads(line) for line in f]
    assert any(e["kind"] == "actor_crash" and e.get("actor") == 0 for e in events)
