"""Port parity: the direct actor-to-shard data plane (``--shard-direct``).

``r2d2dpg_torch/fleet/{actor,ingest,shard,sampler}.py``'s split planes
against ``r2d2dpg_tpu/fleet/``, all EXACT: a zero-quota SAMPLE_REQ (the
advert poke) refreshes the learner's view of a shard and leaves its draw
stream untouched, so a poked port shard draws bitwise as a never-poked
one and as a poked JAX shard; the HELLO and STATS acks carry the same
shard assignment as JAX's ingest server and a K_STATS frame banks the
same sums as the forwarded path; with no assignment function no ack
carries one; a ``plane="data"`` connection holds the HELLO token and its
bytes land only in ``r2d2dpg_fleet_data_bytes_{in,out}_total``.  Then,
in process: a thread actor ships every batch directly, and under
``partition_data_plane`` falls back loudly, re-dials and loses no
accounting; and the train CLI runs the direct plane with every chaos
kind the sampler path takes, on shard processes.
"""

import os
import queue
import threading
import time

import numpy as np
import pytest

from r2d2dpg_tpu.fleet import IngestServer as JIngestServer
from r2d2dpg_tpu.fleet import shard as jshard
from r2d2dpg_tpu.fleet import wire as jwire
from r2d2dpg_tpu.replay import sharded as jsh
from r2d2dpg_torch.configs import PENDULUM_TINY
from r2d2dpg_torch.fleet import (
    FleetActor,
    FleetConfig,
    IngestServer,
    SamplerLearner,
    transport,
    wire,
)
from r2d2dpg_torch.fleet.shard import RemoteShard, RemoteShardSet, ShardServer
from r2d2dpg_torch.fleet.transport import (
    K_ACK,
    K_HELLO,
    K_SEQS,
    K_STATS,
    hello_auth_proof,
    pack_hello,
    pack_obj,
    recv_frame,
    send_frame,
    send_frame_parts,
    unpack_obj,
)
from r2d2dpg_torch.obs import get_flight_recorder
from r2d2dpg_torch.obs import registry as obs_registry
from r2d2dpg_torch.replay.sharded import ReplayShard
from r2d2dpg_torch.utils.codes import OK, REFUSED_AUTH
from test_torch_sampler import _pair, _swallow

pytestmark = pytest.mark.shard_direct


@pytest.fixture
def fresh_obs(monkeypatch):
    """A fresh process registry: the per-plane byte counters are process
    singletons, and another test's traffic must not reach this one's."""
    monkeypatch.setattr(obs_registry, "_REGISTRY", obs_registry.Registry())
    monkeypatch.setattr(obs_registry, "_MIRROR", obs_registry.RemoteMirror())
    return obs_registry.get_registry()


def _server(shard_id=0, epoch=1, capacity=8, auth=None):
    return ShardServer(ReplayShard(capacity, alpha=1.0, shard_id=shard_id),
                       epoch=epoch, seed=0, auth_token=auth).start()


def _shard_set(srvs, auth=None, mod=None):
    addrs = {s.shard.shard_id: s.address for s in srvs}
    cls = RemoteShardSet if mod is None else mod.RemoteShardSet
    w = wire.WireConfig() if mod is None else jwire.WireConfig()
    return cls(len(srvs), lambda sid: addrs[sid], wire_config=w, auth_token=auth,
               rejoin_interval_s=0.0)


def _ack(sock):
    kind, payload = recv_frame(sock)
    while kind != K_ACK:
        kind, payload = recv_frame(sock)
    return unpack_obj(payload)  # wire-lint: control


def _hello(sock, **extra):
    send_frame(sock, K_HELLO, pack_hello(
        {"actor_id": 0, **wire.negotiation_fields(wire.WireConfig()), **extra}))


# ------------------------------------------------------- advert refresh poke
def test_zero_quota_poke_refreshes_advert_and_keeps_draws_bitwise():
    jstaged, staged = _pair(np.random.default_rng(3), 4)
    srv_a, srv_b = _server(), _server()
    jsrv = jshard.ShardServer(jsh.ReplayShard(8, alpha=1.0, shard_id=0),
                              epoch=1, seed=0).start()
    ss_a, ss_b = _shard_set([srv_a]), _shard_set([srv_b])
    jss = _shard_set([jsrv], mod=jshard)
    try:
        ss_a.add(0, {"staged": staged, "env_steps_delta": 4.0})
        ss_b.add(0, {"staged": staged, "env_steps_delta": 4.0})
        jss.add(0, {"staged": jstaged, "env_steps_delta": 4.0})
        # A learner-side view that never exchanged reads the optimistic
        # zero a direct-plane cold start would.
        fresh = RemoteShard(0, lambda: srv_a.address, wire_config=wire.WireConfig(),
                            auth_token=None,
                            max_frame_bytes=transport.MAX_FRAME_BYTES,
                            read_deadline_s=30.0)
        assert fresh.occupancy == 0
        ack = fresh.refresh_advert()
        assert ack["poke"] is True and ack["epoch"] == 1
        assert fresh.occupancy == 4
        assert fresh.scaled_sum == pytest.approx(float(staged.priorities.sum()))
        assert ss_a.refresh_adverts() == 1 and ss_a.occupancy_total() == 4
        assert jss.refresh_adverts() == 1
        jack = jss.shards[0].refresh_advert()
        assert {k: v for k, v in jack.items()} == {
            k: v for k, v in ss_a.shards[0].refresh_advert().items()}
        for _ in range(3):
            ss_a.refresh_adverts()
            jss.refresh_adverts()
        ra = ss_a.shards[0].sample(5, req_id=1)
        rb = ss_b.shards[0].sample(5, req_id=1)
        rj = jss.shards[0].sample(5, req_id=1)
        for k in ("slots", "gens", "probs"):
            np.testing.assert_array_equal(ra[k], rb[k], err_msg=k)
            np.testing.assert_array_equal(ra[k], rj[k], err_msg=k)
        np.testing.assert_array_equal(ra["staged"].seq.obs, rj["staged"].seq.obs)
        fresh.close()
    finally:
        for x in (ss_a, ss_b, jss, srv_a, srv_b, jsrv):
            (x.close if hasattr(x, "close") else x.stop)()


# ------------------------------------- assignment acks + K_STATS accounting
def _control_exchange(ingest_cls, srv, ss, stats_frames):
    """HELLO then K_STATS frames on one control connection; returns the
    acks with the shard's address normalized."""
    ingest = ingest_cls(queue.Queue(maxsize=4), shards=ss,
                        shard_assignment_fn=ss.assignment_for, expected_actors=1)
    ingest.start()
    ss.refresh_adverts()
    sock = transport.connect(ingest.connect_address, read_deadline_s=30.0)
    acks = []
    try:
        _hello(sock)
        acks.append(_ack(sock))
        for msg in stats_frames:
            send_frame(sock, K_STATS, pack_obj(msg))  # wire-lint: control
            acks.append(_ack(sock))
    finally:
        sock.close()
        ingest.stop()
    for a in acks:
        if "shard_assignment" in a:
            assert a["shard_assignment"]["address"] == srv.address
            a["shard_assignment"]["address"] = "<shard>"
    return acks


STATS_FRAMES = [
    {"phase": 3, "param_version": 0, "env_steps_delta": 16.0, "ep_return_sum": -2.5,
     "ep_count": 2.0},
    {"phase": 4, "param_version": 0, "env_steps_delta": 8.0, "ep_return_sum": 0.0,
     "ep_count": 0.0},
]


def test_hello_and_stats_acks_carry_assignment_and_bank_like_forwarding():
    srv, jsrv = _server(), jshard.ShardServer(
        jsh.ReplayShard(8, alpha=1.0, shard_id=0), epoch=1, seed=0).start()
    ss, jss = _shard_set([srv]), _shard_set([jsrv], mod=jshard)
    try:
        acks = _control_exchange(IngestServer, srv, ss, STATS_FRAMES)
        assert acks == _control_exchange(JIngestServer, jsrv, jss, STATS_FRAMES)
        assert [a["code"] for a in acks] == [OK] * 3
        assert acks[0]["shard_assignment"] == {"shard": 0, "address": "<shard>",
                                               "epoch": 1}
        banked = ss.pop_stats()
        assert banked == jss.pop_stats()
        # The same deltas through the forwarded path bank the same sums.
        _, staged = _pair(np.random.default_rng(0), 2)
        for msg in STATS_FRAMES:
            ss.add(0, {**msg, "staged": staged})
        assert ss.pop_stats() == banked == {
            "env_steps_delta": 24.0, "ep_return_sum": -2.5, "ep_count": 2.0}
    finally:
        for x in (ss, jss, srv, jsrv):
            (x.close if hasattr(x, "close") else x.stop)()


def test_assignment_none_while_shard_dead_or_unpublished():
    srv = _server()
    addrs = {0: None}
    ss = RemoteShardSet(1, lambda sid: addrs[sid], wire_config=wire.WireConfig())
    try:
        assert ss.assignment_for("0") is None  # no address published yet
        addrs[0] = srv.address
        assert ss.assignment_for("0") == {"shard": 0, "address": srv.address,
                                          "epoch": 0}
        ss.shards[0].alive = False
        assert ss.assignment_for("0") is None
    finally:
        ss.close()
        srv.stop()


def test_hello_ack_has_no_assignment_without_fn():
    acks = []
    for cls in (IngestServer, JIngestServer):
        ingest = cls(queue.Queue(maxsize=4), expected_actors=1)
        ingest.start()
        sock = transport.connect(ingest.connect_address, read_deadline_s=30.0)
        try:
            _hello(sock)
            acks.append(_ack(sock))
        finally:
            sock.close()
            ingest.stop()
    assert acks[0] == acks[1] == {"code": OK, "param_version": 0}


# --------------------------------------------------- per-plane byte counters
def test_data_plane_seqs_auth_and_byte_separation(fresh_obs):
    reg = fresh_obs
    token = "secret"
    srv = _server(auth=token)
    ss = _shard_set([srv], auth=token)

    def data_totals():
        snap = reg.snapshot()
        return tuple(sum(s["value"] for s in snap.get(n, {}).get("samples", ()))
                     for n in ("r2d2dpg_fleet_data_bytes_in_total",
                               "r2d2dpg_fleet_data_bytes_out_total"))

    try:
        bad = transport.connect(srv.address, read_deadline_s=10.0)
        _hello(bad, plane="data")
        assert _ack(bad)["code"] == REFUSED_AUTH
        bad.close()
        sock = transport.connect(srv.address, read_deadline_s=10.0)
        _hello(sock, plane="data", auth=hello_auth_proof(token))
        assert _ack(sock)["code"] == OK
        _, staged = _pair(np.random.default_rng(0), 3)
        # The body's actor claim is ignored on a data leg: the slots carry
        # the identity the HELLO bound.
        send_frame_parts(sock, K_SEQS, wire.TreePacker(wire.WireConfig()).pack(
            {"staged": staged, "actor": 99}))
        assert _ack(sock)["occupancy"] == 3
        drawn = srv.shard.sample(16, np.random.default_rng(0)).actors
        assert set(np.asarray(drawn).tolist()) == {0}
        # The handler counts after each send returns: settle first.
        d = data_totals()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            time.sleep(0.02)
            cur = data_totals()
            if cur == d:
                break
            d = cur
        assert d[0] > 0 and d[1] > 0
        assert ss.forward_bytes_total == 0
        # A forwarded push moves forward_bytes_total and only it.
        ss.add(0, {"staged": staged})
        assert ss.forward_bytes_total > 0
        assert data_totals() == d
        sock.close()
    finally:
        ss.close()
        srv.stop()


# ------------------------------------------------------- in-process drills
def _direct_run(chaos_spec=None, phases=4):
    """One thread actor on the direct plane into two in-process shard
    servers; returns (stats, counters, residue, actor, shard set, kinds)."""
    trainer = PENDULUM_TINY.build("cpu")
    cap = trainer.config.capacity // 2
    srvs = [ShardServer(ReplayShard(cap, alpha=trainer.config.priority_alpha,
                                    shard_id=i), epoch=1, seed=0).start()
            for i in range(2)]
    ss = _shard_set(srvs)
    learner = SamplerLearner(trainer, FleetConfig(num_actors=1, idle_timeout_s=60,
                                                  shard_direct=True),
                             num_shards=2, shard_set=ss)
    address = learner.start()
    actor = FleetActor(PENDULUM_TINY, actor_id=0, num_actors=1, address=address,
                       seed=0, shard_direct=True, chaos_spec=chaos_spec, device="cpu")
    n0 = len(get_flight_recorder().events())
    th = threading.Thread(target=_swallow, args=(actor.run,), daemon=True)
    th.start()
    try:
        learner.run(phases, state=trainer.init(), log_every=0)
        # An orderly drain first: the in-flight exchange finishes, so the
        # accounting ledger below closes.
        actor.request_drain()
        th.join(timeout=30)
        assert not th.is_alive()
        kinds = [e["kind"] for e in get_flight_recorder().events()[n0:]]
        return (dict(learner.stats()), dict(learner.counters()), ss.pop_stats(),
                actor, ss, kinds)
    finally:
        learner.close()
        ss.close()
        for s in srvs:
            s.stop()


def _ledger_closes(counters, residue, actor):
    banked = counters["env_steps_total"] + residue["env_steps_delta"]
    assert banked + actor._pending_stats["env_steps_delta"] == pytest.approx(
        actor._last_env_steps)
    assert counters["env_steps_total"] > 0


def test_direct_plane_ships_every_batch_past_the_learner():
    stats, counters, residue, actor, ss, kinds = _direct_run()
    assert stats["train_phases"] == 4 and stats["sheds"] == 0
    assert ss.forward_bytes_total == 0
    assert "data_plane_dialed" in kinds and "data_plane_fallback" not in kinds
    _ledger_closes(counters, residue, actor)


@pytest.mark.chaos
def test_partition_data_plane_falls_back_and_redials():
    stats, counters, residue, actor, ss, kinds = _direct_run("partition_data_plane@p2")
    assert stats["train_phases"] == 4 and stats["sheds"] == 0
    # The partitioned batch crossed the learner: the loud fallback.
    assert ss.forward_bytes_total > 0
    assert "chaos_inject" in kinds and "data_plane_fallback" in kinds
    first = kinds.index("data_plane_fallback")
    assert kinds.index("data_plane_dialed") < first
    assert "data_plane_dialed" in kinds[first:]
    _ledger_closes(counters, residue, actor)


def test_train_cli_direct_plane_with_chaos_on_shard_procs(tmp_path, capsys):
    """``train --shard-procs 2 --shard-direct 1 --chaos-spec ...``: every
    actor dials its shard, the learner-side faults fire on the pull
    clock, ``stall_shard`` inside a shard process, and nothing is left
    unfired."""
    from r2d2dpg_torch.obs.flight import expand_flight_paths, merge_flight_files
    from r2d2dpg_torch.train import main

    spec = ("partition_data_plane@p3,stall_shard@p4:1s,partition_shard@p4,"
            "stall_sampler@p6:0.5s,kill_sampler_conn@p7")
    t0 = time.time()
    main(["--config", "pendulum_tiny", "--actors", "2", "--replay-shards", "2",
          "--shard-procs", "2", "--shard-direct", "1", "--phases", "12",
          "--log-every", "6", "--chaos-spec", spec, "--device", "cpu",
          "--logdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "chaos faults never fired" not in out
    assert "left no injection evidence" not in out
    # This process's ring also holds earlier tests' events.
    events, _ = merge_flight_files(expand_flight_paths([str(tmp_path)]))
    events = [e for e in events if e["t_wall"] >= t0]
    injected = sorted(e["fault"] for e in events if e["kind"] == "chaos_inject")
    assert injected == sorted(f.split("@")[0] for f in spec.split(","))
    assert {e["actor"] for e in events if e["kind"] == "data_plane_dialed"} == {0, 1}
    assert not [e for e in events if e["kind"] in ("chaos_unfired", "shard_rejoin")]
    stats = next(x for x in out.splitlines() if x.startswith("fleet: ") and "wall_s" in x)
    words = stats.split()[1:]
    stats = {k: float(v) for k, v in zip(words[::2], words[1::2])}
    assert stats["train_phases"] == 12 and stats["sheds"] == 0
    assert os.path.exists(tmp_path / "flight_shard0.jsonl")
