"""Port parity: the standalone replay shard tier (``--shard-procs N``).

``r2d2dpg_torch/fleet/shard.py`` (``ShardServer``, ``RemoteShard``,
``RemoteShardSet``, ``ShardProcTier``), the remote half of
``fleet/sampler.py`` and the supervisor's ``shard`` role, against
``r2d2dpg_tpu/fleet/shard.py`` and ``r2d2dpg_tpu/fleet/sampler.py``.

Tolerances: all BITWISE.  A BATCH through a real socket decodes equal to
the in-learner loopback's; a port client reading a JAX shard server gets
the port server's batch; a remote pull (quotas, req ids, slots,
generations, epochs, permutation, float64 combined probabilities,
sequences) equals the JAX remote pull over JAX servers and equals itself
with 1 or N pullers; the supervisor's ``shard`` role records JAX's
events.  The shard processes of the CLI and tier tests run at
pendulum_tiny width on the CPU, with no card visible.
"""

import dataclasses
import os
import threading
import time

import numpy as np
import pytest

from r2d2dpg_tpu.fleet import FleetConfig as JFleetConfig
from r2d2dpg_tpu.fleet import SamplerLearner as JSamplerLearner
from r2d2dpg_tpu.fleet import shard as jshard
from r2d2dpg_tpu.fleet import wire as jwire
from r2d2dpg_tpu.replay import sharded as jsh
from r2d2dpg_torch.configs import PENDULUM_TINY
from r2d2dpg_torch.fleet import FleetActor, FleetConfig, SamplerLearner, wire
from r2d2dpg_torch.fleet.shard import (
    RemoteShard,
    RemoteShardSet,
    ShardProcTier,
    ShardServer,
    ShardUnavailableError,
)
from r2d2dpg_torch.fleet.supervisor import ActorSupervisor, SupervisorConfig
from r2d2dpg_torch.fleet.transport import MAX_FRAME_BYTES
from r2d2dpg_torch.obs import get_flight_recorder, get_registry
from r2d2dpg_torch.replay.arena import StagedSequences
from r2d2dpg_torch.replay.sharded import ReplayShard
from test_torch_fleet import _FakeProc
from test_torch_sampler import _assert_seq_equal, _pair, _swallow

pytestmark = pytest.mark.shard


def _server(shard_id=0, epoch=1, capacity=8, auth=None, seed=0):
    return ShardServer(ReplayShard(capacity, alpha=1.0, shard_id=shard_id),
                       epoch=epoch, seed=seed, auth_token=auth).start()


def _client(srv, auth=None):
    return RemoteShard(srv.shard.shard_id, lambda: srv.address,
                       wire_config=wire.WireConfig(), auth_token=auth,
                       max_frame_bytes=MAX_FRAME_BYTES, read_deadline_s=30.0)


def _kinds(n0):
    return [e["kind"] for e in get_flight_recorder().events()[n0:]]


# ------------------------------------------------------- determinism anchor
def test_socket_vs_loopback_batch_bitwise():
    """The same shard sample through a real ShardServer socket and through
    the in-learner loopback pack/unpack decodes bitwise equal (the shard
    process seeds its draws by (seed, shard, epoch))."""
    _, staged = _pair(np.random.default_rng(0), 4)
    srv = _server(capacity=8)
    client = _client(srv)
    try:
        client.forward_seqs(staged, actor=3)
        local = ReplayShard(8, alpha=1.0, shard_id=0)
        local.add(staged.seq, staged.priorities, behavior=staged.behavior_version,
                  collect=staged.collect_id, actor=3)
        resp = client.sample(5, req_id=1)
        s = local.sample(5, np.random.default_rng((0, 0, 1)))
        packer, unpacker = wire.TreePacker(wire.WireConfig()), wire.TreeUnpacker()
        loop = wire.unpack_shard_batch(unpacker.unpack(b"".join(
            bytes(p) for p in wire.pack_shard_batch(
                packer, req_id=1, shard=0,
                staged=StagedSequences(seq=s.seq, priorities=None),
                slots=s.slots, gens=s.gens, probs=s.probs,
                priority_sum=local.scaled_sum(), occupancy=local.occupancy(), epoch=1,
                behavior=s.behavior, collect=s.collect, actors=s.actors))))
        for k in ("slots", "gens", "probs", "behavior", "collect", "actors"):
            np.testing.assert_array_equal(resp[k], loop[k], err_msg=k)
        _assert_seq_equal(resp["staged"].seq, loop["staged"].seq)
        assert resp["epoch"] == loop["epoch"] == 1
        assert resp["priority_sum"] == loop["priority_sum"]
        assert list(resp["actors"]) == [3] * 5
    finally:
        client.close()
        srv.stop()


def test_port_client_reads_a_jax_shard_server_bitwise():
    """The tier's wire is the JAX package's: a port ``RemoteShard`` fed by
    a JAX ``ShardServer`` gets the batch a port server serves from the
    same adds, and its PRIO write-back applies there."""
    _, staged = _pair(np.random.default_rng(1), 6)
    jsrv = jshard.ShardServer(jsh.ReplayShard(16, alpha=0.6, shard_id=1),
                              epoch=2, seed=4).start()
    psrv = ShardServer(ReplayShard(16, alpha=0.6, shard_id=1), epoch=2, seed=4).start()
    clients = [RemoteShard(1, (lambda s=s: s.address), wire_config=wire.WireConfig(),
                           auth_token=None, max_frame_bytes=MAX_FRAME_BYTES,
                           read_deadline_s=30.0) for s in (jsrv, psrv)]
    try:
        acks = [c.forward_seqs(staged, actor=7) for c in clients]
        assert acks[0] == acks[1]
        resps = [c.sample(9, req_id=4) for c in clients]
        for k in ("slots", "gens", "probs", "behavior", "collect", "actors"):
            np.testing.assert_array_equal(resps[0][k], resps[1][k], err_msg=k)
        _assert_seq_equal(resps[0]["staged"].seq, resps[1]["staged"].seq)
        prios = np.linspace(0.5, 3.0, 9).astype(np.float32)
        oks = [c.write_back(r["slots"], r["gens"], prios, epoch=2)
               for c, r in zip(clients, resps)]
        assert oks[0] == oks[1] and oks[0]["applied"] == 9
        np.testing.assert_array_equal(jsrv.shard._priority, psrv.shard._priority)
    finally:
        for c in clients:
            c.close()
        jsrv.stop()
        psrv.stop()


# ----------------------------------------------------------- shard protocol
def test_shard_server_auth_epoch_and_stale_prio_fence():
    """HELLO auth refusal, the SEQS ack advertisement, the BATCH epoch
    stamp, the shard-side stale-epoch PRIO fence, and an empty shard's
    empty-marked ack that keeps the connection usable."""
    srv = _server(shard_id=3, epoch=7, auth="sekrit")
    n0 = len(get_flight_recorder().events())
    rng = np.random.default_rng(2)
    try:
        bad = _client(srv, auth="wrong")
        with pytest.raises(RuntimeError, match="refused"):
            bad.forward_seqs(_pair(rng, 3)[1])
        bad.close()
        client = _client(srv, auth="sekrit")
        _, staged = _pair(rng, 3)
        staged = dataclasses.replace(staged, priorities=np.array([1.0, 2.0, 4.0], np.float32))
        ack = client.forward_seqs(staged)
        assert ack["code"] == "ok" and ack["epoch"] == 7
        assert ack["occupancy"] == 3 and ack["scaled_sum"] == 7.0
        assert ack["priority_sum"] == 7.0 and ack["evictions"] == 0
        assert client.epoch == 7 and client.occupancy == 3
        resp = client.sample(2, req_id=5)
        assert resp["epoch"] == 7 and resp["req_id"] == 5
        ok = client.write_back(resp["slots"], resp["gens"], np.full(2, 9.0, np.float32),
                               epoch=7)
        assert ok["applied"] == 2 and not ok["stale"]
        stale = client.write_back(resp["slots"], resp["gens"], np.full(2, 1.0, np.float32),
                                  epoch=6)
        assert stale["applied"] == 0 and stale["stale"]
        assert get_registry().get("r2d2dpg_shard_stale_epoch_prio_total").labels(
            shard="3").value >= 1
        empty_srv = _server(shard_id=9, epoch=1)
        empty_client = _client(empty_srv)
        try:
            assert empty_client.sample(3, req_id=1) is None
            assert empty_client.scaled_sum == 0.0
            empty_client.forward_seqs(_pair(rng, 3)[1])
            assert empty_client.sample(2, req_id=2) is not None
        finally:
            empty_client.close()
            empty_srv.stop()
        evs = [e for e in get_flight_recorder().events()[n0:]
               if e["kind"] == "stale_epoch_prio_ignored"]
        assert evs and evs[-1]["got_epoch"] == 6 and evs[-1]["epoch"] == 7
        assert "shard_auth_refused" in _kinds(n0)
        client.close()
    finally:
        srv.stop()


def test_remote_set_reroute_renorm_and_epoch_fenced_rejoin():
    """Server 0 stops (dial refused): the set marks it dead, its weight is
    0, its actors route to the survivor, the accounting banks anyway; a new
    incarnation under a bumped epoch rejoins with its stale advert zeroed
    and its evictions banked, and routing returns home."""
    addrs = {}
    srv0, srv1 = _server(shard_id=0, epoch=1), _server(shard_id=1, epoch=1)
    addrs[0], addrs[1] = srv0.address, srv1.address
    ss = RemoteShardSet(2, lambda sid: addrs[sid], wire_config=wire.WireConfig(),
                        rejoin_interval_s=0.0)
    n0 = len(get_flight_recorder().events())
    rng = np.random.default_rng(3)
    one = np.ones(3, np.float32) * 2.0
    try:
        for sid in (0, 1):
            ss.add(sid, {"staged": dataclasses.replace(_pair(rng, 3)[1], priorities=one),
                         "env_steps_delta": 9.0})
        assert ss.occupancy_total() == 6
        np.testing.assert_allclose(ss.scaled_sums(), [6.0, 6.0])
        resp = ss.shards[0].sample(2, req_id=1)
        srv0.stop()
        with pytest.raises(ShardUnavailableError):
            ss.shards[0].sample(1, req_id=2)
        ss._mark_dead(0, "drill")
        ss._mark_dead(0, "again")  # single-shot
        assert ss.deaths_total == 1
        np.testing.assert_allclose(ss.scaled_sums(), [0.0, 6.0])
        assert ss.route(0) == 1 and ss.route(2) == 1
        ss.add(0, {"staged": dataclasses.replace(_pair(rng, 3)[1], priorities=one),
                   "env_steps_delta": 9.0, "actor_id": 0})
        assert ss.shards[1].occupancy == 6
        assert ss.pop_stats()["env_steps_delta"] == 27.0
        srv0b = _server(shard_id=0, epoch=2, capacity=8)
        addrs[0] = srv0b.address
        ss.maybe_rejoin()
        assert ss.shards[0].alive and ss.shards[0].epoch == 2
        assert ss.route(0) == 0 and ss.rejoins_total == 1
        np.testing.assert_allclose(ss.scaled_sums(), [0.0, 12.0])
        kinds = _kinds(n0)
        assert kinds.count("shard_dead") == 1 and "shard_quota_renorm" in kinds
        assert "shard_rejoin" in kinds
        # Handles of incarnation 1 never cross to incarnation 2.
        assert resp["epoch"] == 1 != ss.shards[0].epoch
        srv0b.stop()
    finally:
        ss.close()
        srv1.stop()


# ------------------------------------------------------------ remote pulls
def _tier(mod_server, mod_shard, mod_set, wire_mod, n=2, seed=0):
    servers = [mod_server(mod_shard(64, alpha=0.6, shard_id=i), epoch=1, seed=seed).start()
               for i in range(n)]
    addrs = {i: s.address for i, s in enumerate(servers)}
    ss = mod_set(n, lambda sid: addrs[sid], wire_config=wire_mod.WireConfig(),
                 rejoin_interval_s=0.0)
    return servers, ss


def _feed(ss, pairs, which):
    for i, pair in enumerate(pairs):
        actor = str(i % 3)
        ss.add(ss.route(actor), {"staged": pair[which], "actor_id": actor,
                                 "env_steps_delta": 1.0})


def _close(servers, ss):
    ss.close()
    for s in servers:
        s.stop()


def test_remote_pull_equals_jax_and_pullers_are_bitwise(tmp_path):
    """The same adds into three 2-shard tiers (JAX servers for the JAX
    learner, port servers for the port learner with 1 and with 2
    pullers): two phases of remote pull and write-back are bitwise equal
    across all three."""
    from r2d2dpg_tpu.configs import PENDULUM_TINY as J_TINY

    rng = np.random.default_rng(8)
    pairs = [_pair(rng, 4) for _ in range(8)]
    js, jss = _tier(jshard.ShardServer, jsh.ReplayShard, jshard.RemoteShardSet, jwire)
    p1, pss1 = _tier(ShardServer, ReplayShard, RemoteShardSet, wire)
    p2, pss2 = _tier(ShardServer, ReplayShard, RemoteShardSet, wire)
    try:
        _feed(jss, pairs, 0)
        _feed(pss1, pairs, 1)
        _feed(pss2, pairs, 1)
        jl = JSamplerLearner(J_TINY.build(), JFleetConfig(num_actors=3, shard_pullers=1),
                             num_shards=2, shard_set=jss)
        learners = [SamplerLearner(PENDULUM_TINY.build("cpu"),
                                   FleetConfig(num_actors=3, shard_pullers=k),
                                   num_shards=2, shard_set=ss)
                    for k, ss in ((1, pss1), (2, pss2))]
        assert [x._pullers for x in learners] == [1, 2]
        rngs = [np.random.default_rng(6) for _ in range(3)]
        for phase in range(2):
            outs = [jl._pull_phase_batches(24, rngs[0])] + [
                x._pull_phase_batches(24, r) for x, r in zip(learners, rngs[1:])]
            for seq, prob, handles, occ in outs[1:]:
                _assert_seq_equal(outs[0][0], seq)
                np.testing.assert_array_equal(outs[0][1], prob)
                assert len(handles) == 4  # shard, slot, gen, epoch
                for a, b in zip(outs[0][2], handles):
                    np.testing.assert_array_equal(a, b)
                assert occ == outs[0][3] == 32
            prios = np.random.default_rng(phase).uniform(0.1, 3.0, 24).astype(np.float32)
            jl._write_back(outs[0][2], prios)
            for x, out in zip(learners, outs[1:]):
                x._write_back(out[2], prios)
            for i in range(2):
                for srv in (p1[i], p2[i]):
                    np.testing.assert_array_equal(js[i].shard._priority, srv.shard._priority)
        assert learners[0]._req_id == learners[1]._req_id == jl._req_id
        assert pss1.sample_bytes_total == pss2.sample_bytes_total == jss.sample_bytes_total
    finally:
        for servers, ss in ((js, jss), (p1, pss1), (p2, pss2)):
            _close(servers, ss)


def test_remote_pull_redistributes_a_dead_shard_and_fences_stale_epochs():
    """Shard 0's process dies between phases: the next pull marks it dead
    mid-phase and draws its quota from the survivor (the full phase
    delivered); a write-back against the dead incarnation's epoch is
    fenced learner-side; a tier with no live shard is waited out to the
    idle timeout, then the run fails loudly."""
    rng = np.random.default_rng(9)
    servers, ss = _tier(ShardServer, ReplayShard, RemoteShardSet, wire)
    learner = SamplerLearner(PENDULUM_TINY.build("cpu"),
                             FleetConfig(num_actors=2, idle_timeout_s=0.5),
                             num_shards=2, shard_set=ss)
    n0 = len(get_flight_recorder().events())
    try:
        _feed(ss, [_pair(rng, 4) for _ in range(6)], 1)
        assert all(s.scaled_sum > 0 for s in ss.shards)
        _, _, handles, _ = learner._pull_phase_batches(16, np.random.default_rng(0))
        servers[0].stop()
        _, prob, h2, occ = learner._pull_phase_batches(16, np.random.default_rng(1))
        assert not ss.shards[0].alive and set(h2[0].tolist()) == {1}
        assert len(prob) == 16 and occ == ss.shards[1].occupancy
        kinds = _kinds(n0)
        assert "shard_dead" in kinds and "shard_draws_redistributed" in kinds
        learner._write_back(handles, np.ones(16, np.float32))
        assert "prio_dropped_shard_dead" in _kinds(n0)
        ss.shards[1].epoch += 1  # a restart between sample and verdict
        learner._write_back(h2, np.ones(16, np.float32))
        assert "stale_epoch_prio_dropped" in _kinds(n0)
        servers[1].stop()
        ss._mark_dead(1, "drill")
        with pytest.raises(RuntimeError, match="sampler starved"):
            learner._pull_phase_batches(16, np.random.default_rng(2))
    finally:
        _close(servers, ss)


def test_prefetch_runs_with_a_thread_actor():
    """``--shard-prefetch 1`` on an in-process standalone tier with the
    port's actor in a thread: the schedule completes, nothing sheds."""
    servers, ss = _tier(ShardServer, ReplayShard, RemoteShardSet, wire)
    trainer = PENDULUM_TINY.build("cpu")
    learner = SamplerLearner(trainer, FleetConfig(num_actors=1, idle_timeout_s=60,
                                                  shard_prefetch=1),
                             num_shards=2, shard_set=ss)
    address = learner.start()
    actor = FleetActor(PENDULUM_TINY, actor_id=0, num_actors=1, address=address,
                       seed=0, device="cpu")
    th = threading.Thread(target=_swallow, args=(actor.run,), daemon=True)
    th.start()
    try:
        state = learner.run(4, log_every=0)
    finally:
        learner.close()
        th.join(timeout=30)
        _close(servers, ss)
    stats = learner.stats()
    assert state.train.step == 4 and stats["train_phases"] == 4
    assert stats["sheds"] == 0 and stats["shard_deaths"] == 0
    assert stats["sample_bytes_total"] == ss.sample_bytes_total > 0
    assert stats["shard_forward_bytes_total"] > 0


# ------------------------------------------------------- supervisor role
def test_supervisor_shard_role_events_equal_jax():
    """A crash, a restart, a give-up and an explicit respawn under the
    ``shard`` role on a fake clock: the port records JAX's events (kinds
    and ``shard_proc`` keys) and its ``r2d2dpg_shard_*`` metric names."""
    from r2d2dpg_tpu.fleet.supervisor import ActorSupervisor as JSup
    from r2d2dpg_tpu.fleet.supervisor import SupervisorConfig as JCfg
    from r2d2dpg_tpu.obs import get_flight_recorder as j_recorder

    rows = {}
    for label, cls, cfg_cls, rec in (("jax", JSup, JCfg, j_recorder()),
                                     ("port", ActorSupervisor, SupervisorConfig,
                                      get_flight_recorder())):
        sup = cls(lambda i: ["unused"], 1, config=cfg_cls(backoff_base_s=0.5,
                                                          max_restarts=1),
                  clock=lambda: 0.0, role="shard", id_field="shard_proc")

        def fake_spawn(i, sup=sup):
            sup._slots[i].proc = _FakeProc()
            sup._slots[i].restart_at = None

        sup._spawn = fake_spawn
        n0 = len(rec.events())
        slot = sup._slots[0]
        slot.proc = _FakeProc(returncode=-9)
        sup._poll_once(10.0)
        sup._poll_once(10.5)
        slot.proc = _FakeProc(returncode=-9)
        sup._poll_once(20.0)
        assert slot.gave_up
        assert sup.spawn_slot(0, origin="respawn") and not sup.spawn_slot(0)
        rows[label] = [(e["kind"], e.get("shard_proc"), e.get("restarts"),
                        e.get("resurrected")) for e in rec.events()[n0:]]
    assert rows["port"] == rows["jax"]
    assert [r[0] for r in rows["port"]] == ["shard_crash", "shard_restart", "shard_crash",
                                           "shard_gave_up", "shard_spawn"]
    reg = get_registry()
    assert reg.get("r2d2dpg_shard_alive") is not None
    assert reg.get("r2d2dpg_shard_restarts_total") is not None


# ----------------------------------------------------------- real processes
def _wait(pred, seconds=60):
    deadline = time.monotonic() + seconds
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.05)
    return pred()


def test_shard_proc_tier_kill_restart_rejoin(tmp_path):
    """Two real shard processes at pendulum_tiny width, no card visible:
    traffic reaches both; process 0 is killed, the next add to shard 0
    re-routes to shard 1 (one death), the supervisor restarts it and the
    shard rejoins under epoch 2, empty, and serves both legs."""
    tier = ShardProcTier(num_shards=2, num_procs=2, capacity_per_shard=32, alpha=0.6,
                         prioritized=True, dirpath=str(tmp_path / "shards"), seed=1,
                         flight_dir=str(tmp_path),
                         supervisor_config=SupervisorConfig(backoff_base_s=0.2,
                                                            poll_s=0.05))
    argv = tier._argv(1)
    tier._epochs.clear()
    assert argv[1:3] == ["-m", "r2d2dpg_torch.fleet.shard"]
    assert argv[argv.index("--shard-ids") + 1] == "1"
    assert argv[argv.index("--epoch") + 1] == "1"
    ss = tier.shard_set
    rng = np.random.default_rng(4)
    n0 = len(get_flight_recorder().events())
    tier.start()
    try:
        for actor in ("0", "1"):
            ss.add(ss.route(actor), {"staged": _pair(rng, 4)[1], "actor_id": actor})
        assert [s.occupancy for s in ss.shards] == [4, 4]
        pids = tier.supervisor.pids()
        for pid in pids.values():
            with open(f"/proc/{pid}/environ", "rb") as f:
                assert b"CUDA_VISIBLE_DEVICES=\x00" in f.read() + b"\x00"
            assert not any(os.readlink(f"/proc/{pid}/fd/{fd}").startswith("/dev/nvidia")
                           for fd in os.listdir(f"/proc/{pid}/fd"))
        assert tier.respawn_proc(0) is False  # alive: nothing to respawn
        assert tier.kill_proc(0)
        assert _wait(lambda: 0 not in tier.supervisor.pids())
        ss.add(0, {"staged": _pair(rng, 4)[1], "actor_id": "0"})
        assert not ss.shards[0].alive and ss.shards[1].occupancy == 8
        assert _wait(lambda: tier.restarts_total >= 1)

        def rejoined():
            ss.maybe_rejoin()
            return ss.shards[0].alive

        assert _wait(rejoined)
        assert ss.shards[0].epoch == 2 and ss.shards[0].occupancy == 0
        ss.add(ss.route("0"), {"staged": _pair(rng, 4)[1], "actor_id": "0"})
        assert ss.shards[0].occupancy == 4
        resp = ss.shards[0].sample(2, req_id=9)
        assert resp["epoch"] == 2
        stale = ss.shards[0].write_back(resp["slots"], resp["gens"],
                                        np.ones(2, np.float32), epoch=1)
        assert stale["applied"] == 0 and stale["stale"]
        kinds = _kinds(n0)
        assert kinds.count("shard_dead") == 1
        assert "shard_crash" in kinds and "shard_restart" in kinds
        assert "shard_rejoin" in kinds
    finally:
        tier.stop()
    assert tier.supervisor.alive_count() == 0
    assert os.path.exists(tmp_path / "shard0.log")


def test_train_cli_with_shard_subprocesses(tmp_path, capsys):
    """``train --actors 2 --replay-shards 2 --shard-procs 2`` with real
    actor and shard processes on the CPU: the schedule completes, the
    fleet line carries the tier's counters, and every process is gone."""
    from r2d2dpg_torch.train import main

    state = main(["--config", "pendulum_tiny", "--actors", "2", "--replay-shards", "2",
                  "--shard-procs", "2", "--shard-pullers", "1", "--phases", "3",
                  "--device", "cpu", "--log-every", "1", "--logdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert state.train.step == 3
    assert "2 standalone shard procs" in out
    line = next(x for x in out.splitlines() if x.startswith("fleet: ") and "wall_s" in x)
    words = line.split()[1:]
    stats = dict(zip(words[::2], map(float, words[1::2])))
    assert stats["train_phases"] == 3 and stats["sheds"] == 0
    assert stats["shard_restarts"] == 0 and stats["shard_deaths"] == 0
    assert stats["shard_pullers"] == 1
    assert stats["trained_seqs_total"] == 24 and stats["sample_bytes_total"] > 0
    assert stats["shard_forward_bytes_total"] > 0
    assert sorted(os.listdir(tmp_path / "shards")) == ["shard_proc0.addr",
                                                       "shard_proc1.addr"]
    # The shard processes dumped their flight rings at SIGTERM.
    assert os.path.exists(tmp_path / "flight_shard0.jsonl")
    assert os.path.exists(tmp_path / "flight_shard1.jsonl")


def test_shard_parser_refuses_unported_flags(capsys):
    from r2d2dpg_torch.fleet.shard import parse_args

    base = ["--shard-ids", "0", "--capacity", "8"]
    assert parse_args(base).epoch == 1
    for flag in ("--telem-every", "--shard-direct"):
        with pytest.raises(SystemExit):
            parse_args([*base, flag, "1"])


def test_resume_without_checkpoint_refused_before_any_process(tmp_path):
    """``--resume`` with an empty checkpoint directory is refused with the
    JAX CLI's message before the ingest server, the shard tier or any
    process exists (nothing to orphan, no address directory written)."""
    from r2d2dpg_torch.train import main

    (tmp_path / "ck").mkdir()
    with pytest.raises(SystemExit, match="--resume: no checkpoint found under"):
        main(["--config", "pendulum_tiny", "--actors", "2", "--replay-shards", "2",
              "--shard-procs", "2", "--device", "cpu", "--logdir", str(tmp_path),
              "--checkpoint-dir", str(tmp_path / "ck"), "--resume"])
    assert not (tmp_path / "shards").exists()
