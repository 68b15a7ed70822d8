"""Port parity: chaos drills (``r2d2dpg_torch/fleet/chaos.py``, ``--chaos-spec``).

Against ``r2d2dpg_tpu/fleet/chaos.py``, all EXACT (pure functions and
schedulers): ``parse_chaos_spec`` gives the same ``Fault`` tuples and the
same ``ValueError`` texts; ``fault_target`` the same index over seeds,
spec positions, kinds and fleet sizes; ``send_corrupt_frame`` the same
bytes, which both packages' ``recv_frame`` reject with ``FrameCRCError``;
``ActorChaos``, ``ShardChaos`` and ``ChaosEngine`` fire the same
sequence (injections, sleeps, kills, drops) against the same fakes with
the clock and ``time.sleep`` patched, pending-until-landed and
``unfired()`` included; the dump scans name the same unfired faults.
Then the port alone, as ``tests/test_chaos.py`` drills the JAX package: a
live 2-actor fleet (thread actors on the wire, a torch-free sleeper under
the port's ``ActorSupervisor`` for the kill) paired fault by fault with
its recovery events, and the sampler class's two drills.
"""

import dataclasses
import json
import socket
import sys
import threading
import time
import types

import numpy as np
import pytest

from r2d2dpg_tpu.fleet import chaos as jchaos
from r2d2dpg_tpu.fleet import transport as jtransport
from r2d2dpg_tpu.obs import get_flight_recorder as j_flight
from r2d2dpg_torch.configs import PENDULUM_TINY
from r2d2dpg_torch.fleet import (
    ActorSupervisor,
    ChaosEngine,
    FleetActor,
    FleetConfig,
    FleetLearner,
    SamplerLearner,
    SupervisorConfig,
    parse_chaos_spec,
    transport,
)
from r2d2dpg_torch.fleet import actor as actor_mod
from r2d2dpg_torch.fleet import chaos as pchaos
from r2d2dpg_torch.fleet.transport import FrameCRCError, K_SEQS, recv_frame
from r2d2dpg_torch.obs import get_flight_recorder, get_registry
from test_torch_fleet import _swallow

pytestmark = pytest.mark.chaos

GOOD_SPECS = [
    "kill_actor@p3",
    "kill_actor@p3, stall_actor@p5:4s,corrupt_frame@p7,kill_ingest_conn@p9",
    "kill_sampler_conn@p2,stall_sampler@p3:1s",
    "kill_shard@p2,stall_shard@p3:2s,partition_shard@p4",
    "partition_data_plane@p1,stall_actor@p2:0.75s,stall_shard@p10:2.5s",
    "corrupt_frame@p1,corrupt_frame@p1,kill_actor@p12,kill_actor@p12",
]
# JAX's test_parse_chaos_spec_rejects table, then a few more.
BAD_SPECS = [
    "", "kill_actor", "kill_actor@3", "unknown_fault@p2", "kill_actor@p0",
    "kill_actor@p2:3s", "stall_actor@p2", "kill_sampler_conn@p2:3s",
    "stall_sampler@p2", "kill_shard@p2:3s", "stall_shard@p2",
    "kill_actor@p1,,kill_actor@p2",
    "stall_actor@p2:0s", "partition_data_plane@p2:1s", "Kill_actor@p1",
]


def _injections(recorder, n0):
    keep = ("fault", "phase", "actor", "at_phase", "duration_s", "dropped")
    return [{k: e[k] for k in keep if k in e} for e in recorder.events()[n0:]
            if e["kind"] == "chaos_inject"]


class _Clock:
    """A fake ``time`` module: ``sleep`` advances ``monotonic`` and is
    recorded."""

    def __init__(self):
        self.now = 100.0
        self.slept = []

    def monotonic(self):
        return self.now

    def sleep(self, s):
        self.slept.append(s)
        self.now += s

    def module(self):
        return types.SimpleNamespace(monotonic=self.monotonic, sleep=self.sleep,
                                     time=time.time)


# ------------------------------------------------------------- pure functions
def test_fault_tables_equal_jax():
    for name in ("LEARNER_FAULTS", "ACTOR_FAULTS", "SHARD_PROC_FAULTS",
                 "SAMPLER_FAULTS", "SHARD_FAULTS", "DIRECT_FAULTS",
                 "FAULT_KINDS", "STALL_FAULTS"):
        assert getattr(pchaos, name) == getattr(jchaos, name), name
    assert len(pchaos.FAULT_KINDS) == 10


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_parse_chaos_spec_equals_jax(spec):
    port, ref = pchaos.parse_chaos_spec(spec), jchaos.parse_chaos_spec(spec)
    assert [dataclasses.astuple(f) for f in port] == [
        dataclasses.astuple(f) for f in ref]
    assert [f.index for f in port] == list(range(len(port)))


@pytest.mark.parametrize("bad", BAD_SPECS)
def test_parse_chaos_spec_rejects_like_jax(bad):
    with pytest.raises(ValueError) as want:
        jchaos.parse_chaos_spec(bad)
    with pytest.raises(ValueError) as got:
        pchaos.parse_chaos_spec(bad)
    assert str(got.value) == str(want.value)


def test_fault_target_equals_jax():
    hit = set()
    for seed in (0, 1, 7, 42, 2**31 - 1, 2**40 + 3):
        for index in range(6):
            for kind in pchaos.FAULT_KINDS:
                p = pchaos.Fault(kind=kind, phase=1, index=index)
                j = jchaos.Fault(kind=kind, phase=1, index=index)
                for n in range(0, 9):
                    t = pchaos.fault_target(p, seed, n)
                    assert t == jchaos.fault_target(j, seed, n)
                    assert 0 <= t < max(n, 1)
                    hit.add((n, t))
    # The hash spreads over every actor of every fleet size.
    assert {(n, t) for n in range(1, 9) for t in range(n)} <= hit


@pytest.mark.parametrize("flip_at", [None, 0, 5, -1, 10**6])
def test_send_corrupt_frame_bytes_equal_jax_and_crc_rejected(flip_at):
    parts = [b"header-part", np.arange(40, dtype=np.float32), memoryview(b"tail")]
    frames = []
    for mod in (pchaos, jchaos):
        a, b = socket.socketpair()
        try:
            n = mod.send_corrupt_frame(a, K_SEQS, parts, flip_at=flip_at)
            a.shutdown(socket.SHUT_WR)
            b.settimeout(5)
            frames.append((n, b"".join(iter(lambda: b.recv(65536), b""))))
        finally:
            a.close()
            b.close()
    assert frames[0] == frames[1]
    n, raw = frames[0]
    assert n == len(raw) == transport.HEADER_BYTES + 11 + 160 + 4
    for recv, err in ((recv_frame, FrameCRCError),
                      (jtransport.recv_frame, jtransport.FrameCRCError)):
        a, b = socket.socketpair()
        try:
            a.sendall(raw)
            b.settimeout(5)
            with pytest.raises(err):
                recv(b)
        finally:
            a.close()
            b.close()
    with pytest.raises(ValueError, match="empty payload"):
        pchaos.send_corrupt_frame(None, K_SEQS, [b""])


# ----------------------------------------------------------------- schedulers
ACTOR_SPEC = ("stall_actor@p2:1s,corrupt_frame@p3,partition_data_plane@p1,"
              "corrupt_frame@p3,stall_actor@p5:0.5s,kill_actor@p2,"
              "partition_data_plane@p6")


def _actor_sequence(mod, recorder, monkeypatch, n, actor_id):
    clock = _Clock()
    monkeypatch.setattr(mod, "time", clock.module())
    n0 = len(recorder.events())
    ch = mod.ActorChaos(mod.parse_chaos_spec(ACTOR_SPEC), seed=3, num_actors=n,
                        actor_id=actor_id)
    seq = [(b, ch.maybe_stall(b), ch.partition_data_plane(b),
            ch.corrupt_next_frame(b)) for b in range(1, 9)]
    return seq, clock.slept, _injections(recorder, n0)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_actor_chaos_fires_as_jax(n, monkeypatch):
    fired = 0
    for actor_id in range(n):
        port = _actor_sequence(pchaos, get_flight_recorder(), monkeypatch, n, actor_id)
        ref = _actor_sequence(jchaos, j_flight(), monkeypatch, n, actor_id)
        assert port == ref
        fired += len(port[2])
    # Every actor-side fault fires exactly once across the fleet.
    assert fired == 6


def _shard_sequence(mod, recorder, monkeypatch, procs, proc):
    clock = _Clock()
    monkeypatch.setattr(mod, "time", clock.module())
    n0 = len(recorder.events())
    ch = mod.ShardChaos(
        mod.parse_chaos_spec("stall_shard@p2:1.5s,stall_shard@p4:0.5s,kill_actor@p1,"
                             "stall_shard@p4:2s"),
        seed=11, num_shard_procs=procs, proc_index=proc)
    for _ in range(6):
        ch.on_seqs_frame()
        ch.gate()
        clock.now += 0.25
    return clock.slept, _injections(recorder, n0)


@pytest.mark.parametrize("procs", [1, 2, 3])
def test_shard_chaos_fires_as_jax(procs, monkeypatch):
    fired = 0
    for proc in range(procs):
        port = _shard_sequence(pchaos, get_flight_recorder(), monkeypatch, procs, proc)
        assert port == _shard_sequence(jchaos, j_flight(), monkeypatch, procs, proc)
        fired += len(port[1])
    assert fired == 3


class _Scripted:
    """One fake boundary: each call is logged and answered from a script
    (the last answer repeats)."""

    def __init__(self, log, name, answers):
        self.log, self.name, self.answers = log, name, list(answers)

    def __call__(self, *args, **kwargs):
        self.log.append((self.name, args, tuple(sorted(kwargs.items()))))
        return self.answers.pop(0) if len(self.answers) > 1 else self.answers[0]


ENGINE_SPEC = ("kill_actor@p2,kill_ingest_conn@p3,stall_sampler@p4:1.5s,"
               "kill_sampler_conn@p4,kill_shard@p5,partition_shard@p5,"
               "stall_actor@p1:1s,corrupt_frame@p2,stall_shard@p2:1s,"
               "kill_actor@p30,partition_data_plane@p1")


def _engine_sequence(mod, recorder, monkeypatch, tier):
    clock = _Clock()
    monkeypatch.setattr(mod, "time", clock.module())
    log = []
    # The first kill is a no-op (target mid-backoff), the first drop finds
    # no live connection, the first partition none either: each stays
    # pending and lands on a later phase.
    sup = types.SimpleNamespace(kill_actor=_Scripted(log, "kill_actor", [False, True]))
    srv = types.SimpleNamespace(drop_connection=_Scripted(
        log, "drop_connection", [None, "2", "1"]))
    shard_tier = None
    if tier:
        shard_tier = types.SimpleNamespace(
            num_procs=2, num_shards=4,
            kill_proc=_Scripted(log, "kill_proc", [True]),
            shard_set=types.SimpleNamespace(
                partition=_Scripted(log, "partition", [False, False, True])))
    n0 = len(recorder.events())
    eng = mod.ChaosEngine(mod.parse_chaos_spec(ENGINE_SPEC), seed=5, num_actors=3,
                          supervisor=sup, server=srv, shard_tier=shard_tier)
    unfired = []
    for phase in range(1, 11):
        eng.on_phase(phase)
        unfired.append([(f.kind, f.phase) for f in eng.unfired()])
    return log, clock.slept, unfired, _injections(recorder, n0)


@pytest.mark.parametrize("tier", [True, False], ids=["shard_tier", "no_tier"])
def test_chaos_engine_fires_as_jax(tier, monkeypatch):
    port = _engine_sequence(pchaos, get_flight_recorder(), monkeypatch, tier)
    assert port == _engine_sequence(jchaos, j_flight(), monkeypatch, tier)
    log, slept, unfired, injected = port
    assert slept == [1.5]
    # Pending until landed: the no-op kill of phase 2 is tried again on
    # phase 3, at the same target.
    kills = [c for c in log if c[0] == "kill_actor"]
    assert len(kills) == 2 and kills[0] == kills[1]
    assert ("kill_actor", 30) in unfired[-1]
    if tier:
        assert unfired[-1] == [("kill_actor", 30)]
        assert {i["fault"] for i in injected} == {
            "kill_actor", "kill_ingest_conn", "stall_sampler", "kill_sampler_conn",
            "kill_shard", "partition_shard"}
    else:
        assert ("kill_shard", 5) in unfired[-1] and ("partition_shard", 5) in unfired[-1]


def test_faults_unfired_scans_equal_jax(tmp_path):
    spec = ("corrupt_frame@p2,stall_actor@p5:1s,kill_actor@p3,stall_shard@p4:2s,"
            "partition_data_plane@p1,stall_shard@p4:2s,corrupt_frame@p2")
    faults = pchaos.parse_chaos_spec(spec)
    jfaults = jchaos.parse_chaos_spec(spec)

    def both():
        got = (pchaos.actor_faults_unfired(faults, str(tmp_path), seed=0, num_actors=3)
               + pchaos.shard_faults_unfired(faults, str(tmp_path), seed=0,
                                             num_shard_procs=2))
        want = (jchaos.actor_faults_unfired(jfaults, str(tmp_path), seed=0,
                                            num_actors=3)
                + jchaos.shard_faults_unfired(jfaults, str(tmp_path), seed=0,
                                              num_shard_procs=2))
        assert [dataclasses.astuple(f) for f in got] == [
            dataclasses.astuple(f) for f in want]
        return [(f.kind, f.phase, f.index) for f in got]

    assert len(both()) == 6  # no dumps: every actor and shard fault
    target = {f.index: pchaos.fault_target(f, 0, 2 if f.kind == "stall_shard" else 3)
              for f in faults}

    def line(f, actor):
        return json.dumps({"kind": "chaos_inject", "fault": f.kind, "phase": f.phase,
                           "actor": actor}) + "\n"

    with open(tmp_path / "flight_actor0.jsonl", "w") as fh:
        fh.write("not json\n")
        fh.write(line(faults[0], target[0]))
        fh.write(line(faults[4], (target[4] + 1) % 3))  # the wrong actor
    with open(tmp_path / "flight_actor2.pid77.jsonl", "w") as fh:
        fh.write(line(faults[1], target[1]))
    with open(tmp_path / "flight_shard1.jsonl", "w") as fh:
        fh.write(line(faults[3], target[3]))
    # An actor line in a shard dump is not shard evidence.
    with open(tmp_path / "flight_shard0.jsonl", "w") as fh:
        fh.write(line(faults[4], target[4]))
    left = both()
    assert ("stall_actor", 5, 1) not in left and ("partition_data_plane", 1, 4) in left


# ------------------------------------------------------------ live drills
def _events(n0):
    return get_flight_recorder().events()[n0:]


def _fast_reconnect(monkeypatch):
    monkeypatch.setattr(actor_mod, "RECONNECT_TRIES", 8)
    monkeypatch.setattr(actor_mod, "RECONNECT_BASE_S", 0.1)
    monkeypatch.setattr(actor_mod, "RECONNECT_MAX_S", 0.5)


def test_chaos_multi_fault_drill_in_process_e2e(monkeypatch):
    """kill/stall/corrupt/conn-drop against a live 2-actor fleet: the run
    completes its schedule, env steps never go down, no shed, no fault
    left unfired, and each fault is paired with its recovery event."""
    _fast_reconnect(monkeypatch)
    seed, n_actors, n_train = 0, 2, 8
    spec = "corrupt_frame@p2,stall_actor@p3:2s,kill_actor@p2,kill_ingest_conn@p5"
    trainer = PENDULUM_TINY.build("cpu")
    # A deep queue: handlers never wait for room, so the short heartbeat
    # only fires on real silence.
    learner = FleetLearner(trainer, FleetConfig(
        num_actors=n_actors, queue_depth=16384, idle_timeout_s=120, heartbeat_s=0.75))
    address = learner.start()
    actors = [FleetActor(PENDULUM_TINY, actor_id=i, num_actors=n_actors,
                         address=address, seed=seed, chaos_spec=spec,
                         read_deadline_s=30, device="cpu")
              for i in range(n_actors)]
    threads = [threading.Thread(target=_swallow, args=(a.run, 10**6), daemon=True)
               for a in actors]
    # The kill's victims: torch-free sleepers under the real supervisor.
    sup = ActorSupervisor(
        lambda i: [sys.executable, "-c", "import time; time.sleep(600)"], n_actors,
        config=SupervisorConfig(backoff_base_s=0.1, poll_s=0.05))
    engine = ChaosEngine(parse_chaos_spec(spec), seed=seed, num_actors=n_actors,
                         supervisor=sup, server=learner.server)
    rows = []
    n0 = len(get_flight_recorder().events())
    drills0 = _drill_counts()
    for th in threads:
        th.start()
    try:
        sup.start()
        state = learner.run(n_train, log_every=2,
                            metrics_fn=lambda p, s: rows.append((p, dict(s))),
                            phase_fn=engine.on_phase)
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and sup.restarts_total < 1:
            time.sleep(0.05)
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and not (
                {"peer_dead", "actor_reconnect"} <= {e["kind"] for e in _events(n0)}):
            time.sleep(0.05)
        time.sleep(0.1)
    finally:
        sup.stop()
        learner.close()
        for th in threads:
            th.join(timeout=30)

    assert state.train.step == n_train * trainer.config.learner_steps
    stats = learner.stats()
    assert stats["train_phases"] == n_train and stats["sheds"] == 0
    assert not engine.unfired()
    steps = [s["env_steps"] for _, s in rows]
    assert steps == sorted(steps) and steps[-1] > 0
    events = _events(n0)
    injected = {(e["fault"], e["actor"]) for e in events if e["kind"] == "chaos_inject"}
    assert {f for f, _ in injected} == {
        "kill_actor", "stall_actor", "corrupt_frame", "kill_ingest_conn"}
    kinds = {e["kind"] for e in events}
    assert any("FrameCRCError" in str(e.get("error", ""))
               for e in events if e["kind"] == "ingest_conn_error")
    assert {"peer_dead", "actor_reconnect"} <= kinds
    victim = next(a for f, a in injected if f == "kill_actor")
    for kind in ("actor_crash", "actor_restart"):
        assert any(e["kind"] == kind and e.get("actor") == victim for e in events)
    drop = next(e for e in events if e.get("fault") == "kill_ingest_conn")
    assert drop.get("dropped") is not None
    drills = _drill_counts()
    for kind in ("kill_actor", "stall_actor", "corrupt_frame", "kill_ingest_conn"):
        assert drills.get(kind, 0) - drills0.get(kind, 0) == 1


def _drill_counts():
    snap = get_registry().snapshot().get("r2d2dpg_fleet_chaos_drills_total")
    return {} if snap is None else {
        s["labels"]["fault"]: s["value"] for s in snap["samples"]}


def test_chaos_sampler_drills_in_process_e2e(monkeypatch):
    """``stall_sampler`` and ``kill_sampler_conn`` on a live 2-actor,
    2-shard sampler fleet: the stall reaps nobody and sheds nothing, the
    dropped feed's actor reconnects, env steps never go down."""
    _fast_reconnect(monkeypatch)
    seed, n_actors, n_train = 0, 2, 6
    spec = "stall_sampler@p2:1s,kill_sampler_conn@p3"
    trainer = PENDULUM_TINY.build("cpu")
    learner = SamplerLearner(trainer, FleetConfig(num_actors=n_actors,
                                                  idle_timeout_s=120), num_shards=2)
    address = learner.start()
    actors = [FleetActor(PENDULUM_TINY, actor_id=i, num_actors=n_actors,
                         address=address, seed=seed, device="cpu")
              for i in range(n_actors)]
    threads = [threading.Thread(target=_swallow, args=(a.run,), daemon=True)
               for a in actors]
    engine = ChaosEngine(parse_chaos_spec(spec), seed=seed, num_actors=n_actors,
                         server=learner.server)
    n0 = len(get_flight_recorder().events())
    rows = []
    for th in threads:
        th.start()
    try:
        state = learner.run(n_train, log_every=1,
                            metrics_fn=lambda p, s: rows.append((p, dict(s))),
                            phase_fn=engine.on_phase)
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and not any(
                e["kind"] == "actor_reconnect" for e in _events(n0)):
            time.sleep(0.05)
    finally:
        learner.close()
        for th in threads:
            th.join(timeout=30)

    assert state.train.step == n_train * trainer.config.learner_steps
    stats = learner.stats()
    assert stats["train_phases"] == n_train and stats["sheds"] == 0
    assert not engine.unfired()
    steps = [s["env_steps"] for _, s in rows]
    assert steps == sorted(steps) and steps[-1] > 0
    events = _events(n0)
    assert {e["fault"] for e in events if e["kind"] == "chaos_inject"} == {
        "stall_sampler", "kill_sampler_conn"}
    stall = next(e for e in events if e.get("fault") == "stall_sampler")
    assert stall["duration_s"] == 1.0
    assert not [e for e in events if e["kind"] == "peer_dead"]
    drop = next(e for e in events if e.get("fault") == "kill_sampler_conn")
    assert drop.get("dropped") is not None
    assert any(e["kind"] == "actor_reconnect" for e in events)


def test_actor_refuses_a_malformed_spec_at_startup():
    from r2d2dpg_torch.fleet.actor import main

    with pytest.raises(SystemExit, match="fleet actor 0: unknown chaos fault"):
        main(["--config", "pendulum_tiny", "--connect", "127.0.0.1:1", "--actor-id",
              "0", "--num-actors", "1", "--device", "cpu", "--chaos-spec", "nope@p1"])


def test_shard_proc_refuses_a_malformed_spec_at_startup():
    from r2d2dpg_torch.fleet.shard import main, parse_args

    args = parse_args(["--shard-ids", "0", "--capacity", "8", "--chaos-spec",
                       "stall_shard@p1:1s", "--num-shard-procs", "2", "--proc-index", "1"])
    assert (args.chaos_spec, args.num_shard_procs, args.proc_index) == (
        "stall_shard@p1:1s", 2, 1)
    with pytest.raises(SystemExit, match="shard proc 0: .*needs a duration"):
        main(["--shard-ids", "0", "--capacity", "8", "--chaos-spec", "stall_shard@p1"])


def test_tier_forwards_the_spec_and_proc_count(tmp_path):
    from r2d2dpg_tpu.fleet.shard import ShardProcTier as JTier
    from r2d2dpg_torch.fleet.shard import ShardProcTier

    kw = dict(num_shards=4, num_procs=2, capacity_per_shard=8, alpha=0.6,
              prioritized=True, seed=3, chaos_spec="stall_shard@p3:1s")
    port = ShardProcTier(dirpath=str(tmp_path / "p"), **kw)._argv(1)
    ref = JTier(dirpath=str(tmp_path / "j"), **kw)._argv(1)
    assert port[3:] == [x.replace("/j/", "/p/") for x in ref[3:]]
    assert port[port.index("--chaos-spec") + 1] == "stall_shard@p3:1s"
    assert port[port.index("--num-shard-procs") + 1] == "2"
