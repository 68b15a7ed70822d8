"""Port parity: the fleet telemetry plane (``--obs-fleet``).

Against the JAX package, on the same bytes:

- the ingest fold: one TELEM frame, packed once, sent to both packages'
  ``IngestServer`` over a real connection, gives equal mirror contents
  (``actor=``/``host=`` labels keyed ``actor:<id>``); a reconnect under
  the same id updates the one source in both; a staleness gauge is armed
  at HELLO in both;
- the shard fold: the same TELEM payloads through both packages'
  ``RemoteShardSet._fold_shard_telem`` and ``_arm_telem_staleness``
  under one fake clock give equal mirror contents, equal per-shard
  epochs and equal staleness values at every step (a new epoch restarts
  the clock; a reconnect under the same epoch keeps it);
- malformed pushes cost one ``telem_malformed`` (ingest) or
  ``shard_telem_malformed`` (``RemoteShard._recv``) flight event each and
  the connection stays up, in both packages;
- the actor's TELEM frame, and the shard server's, for an injected
  snapshot, host and ``t_wall`` are byte-equal to JAX's (the shard's
  registry slice and its echo exclusions included).

On the port alone: a live 2-actor pendulum_tiny fleet on the CPU whose
learner serves both actors' labelled series and staleness gauges in one
``/metrics`` scrape.
"""

import queue
import socket
import threading
import time
import types
import urllib.request

import pytest

import r2d2dpg_torch.obs as pobs
import r2d2dpg_tpu.obs as jobs
from r2d2dpg_torch.fleet import actor as p_actor
from r2d2dpg_torch.fleet import ingest as p_ingest
from r2d2dpg_torch.fleet import shard as p_shard
from r2d2dpg_torch.fleet import transport as p_transport
from r2d2dpg_torch.fleet import wire as p_wire
from r2d2dpg_torch.obs import registry as p_registry
from r2d2dpg_tpu.fleet import actor as j_actor
from r2d2dpg_tpu.fleet import ingest as j_ingest
from r2d2dpg_tpu.fleet import shard as j_shard
from r2d2dpg_tpu.fleet import transport as j_transport
from r2d2dpg_tpu.fleet import wire as j_wire
from r2d2dpg_tpu.obs import registry as j_registry

pytestmark = pytest.mark.fleet

PKGS = {
    "jax": types.SimpleNamespace(obs=jobs, registry=j_registry, ingest=j_ingest,
                                 shard=j_shard, transport=j_transport, wire=j_wire,
                                 actor=j_actor),
    "torch": types.SimpleNamespace(obs=pobs, registry=p_registry, ingest=p_ingest,
                                   shard=p_shard, transport=p_transport, wire=p_wire,
                                   actor=p_actor),
}


@pytest.fixture
def fresh_obs(monkeypatch):
    """A fresh registry and remote mirror in both packages for one test:
    the folds read process singletons, and an earlier test's staleness
    closures would otherwise linger."""
    for pkg in PKGS.values():
        monkeypatch.setattr(pkg.registry, "_REGISTRY", pkg.registry.Registry())
        monkeypatch.setattr(pkg.registry, "_MIRROR", pkg.registry.RemoteMirror())


def _snapshot(phases):
    """A registry snapshot (the JAX package's registry renders it; the
    payload is plain data either package can fold)."""
    reg = j_registry.Registry()
    reg.counter("r2d2dpg_actor_phases_total", "collect phases").inc(phases)
    reg.gauge("r2d2dpg_actor_param_version", "version").set(7)
    reg.counter("r2d2dpg_fleet_chaos_drills_total", "drills",
                labelnames=("fault",)).labels(fault="stall_actor").inc()
    reg.histogram("r2d2dpg_trace_collect_seconds", "hop").observe(0.25)
    return reg.snapshot()


def _telem_payload(actor_id, snapshot, host="testhost", t_wall=1.5e9):
    return {"actor_id": actor_id, "host": host, "t_wall": t_wall, "snapshot": snapshot}


def _events(pkg, kind, seq0, **match):
    return [e for e in pkg.obs.get_flight_recorder().events()
            if e["seq"] > seq0 and e["kind"] == kind
            and all(e.get(k) == v for k, v in match.items())]


def _last_seq(pkg):
    events = pkg.obs.get_flight_recorder().events()
    return events[-1]["seq"] if events else -1


def _hello(pkg, sock, actor_id):
    t = pkg.transport
    t.send_frame(sock, t.K_HELLO, t.pack_hello(
        {"actor_id": actor_id, **pkg.wire.negotiation_fields(pkg.wire.WireConfig())}))
    kind, payload = t.recv_frame(sock)
    assert kind == t.K_ACK and t.unpack_obj(payload)["code"] == "ok"


def _wait_for(fn, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(0.01)
    return fn()


def test_telem_payload_packs_byte_equal():
    payload = _telem_payload(3, _snapshot(11))
    assert p_transport.pack_obj(payload) == j_transport.pack_obj(payload)


# ----------------------------------------------------------- the ingest fold
def _ingest_session(pkg, frames):
    """HELLO as actor 3 on a fresh server, send ``frames`` (raw TELEM
    payload bytes), reconnect once and send ``frames`` of the second
    session; returns the mirror's sources after each session, the
    staleness gauge and the fold counter."""
    t = pkg.transport
    srv = pkg.ingest.IngestServer(queue.Queue(maxsize=4), address="127.0.0.1:0")
    srv.start()
    out = []
    try:
        for session in frames:
            sock = t.connect(srv.address)
            sock.settimeout(10)
            _hello(pkg, sock, 3)
            for payload in session:
                t.send_frame(sock, t.K_TELEM, payload)
            want = t.unpack_obj(session[-1])["snapshot"]
            _wait_for(lambda: [s for s in pkg.registry.get_remote_mirror().sources()
                               if s[2] == want])
            out.append(pkg.registry.get_remote_mirror().sources())
            sock.close()
        stale = pkg.registry.get_registry().get(
            "r2d2dpg_fleet_telem_staleness_seconds").labels(actor="3").value
        frames_total = pkg.registry.get_registry().get(
            "r2d2dpg_fleet_telem_frames_total").labels(actor="3").value
    finally:
        srv.stop()
    return out, stale, frames_total


def test_ingest_fold_equals_jax_with_idempotent_reconnect(fresh_obs):
    first = j_transport.pack_obj(_telem_payload(3, _snapshot(11)))
    second = j_transport.pack_obj(_telem_payload(3, _snapshot(12), host="otherhost"))
    port, p_stale, p_frames = _ingest_session(PKGS["torch"], [[first], [second]])
    ref, j_stale, j_frames = _ingest_session(PKGS["jax"], [[first], [second]])
    assert port == ref
    # One source, keyed by the HELLO'd id, updated in place on reconnect.
    assert [len(s) for s in port] == [1, 1]
    key, labels, snap = port[1][0]
    assert key == "actor:3" and labels == {"actor": "3", "host": "otherhost"}
    assert snap["r2d2dpg_actor_phases_total"]["samples"][0]["value"] == 12
    assert p_frames == j_frames == 2
    assert p_stale >= 0.0 and j_stale >= 0.0


def test_ingest_malformed_telem_costs_one_event_each(fresh_obs):
    """Two malformed pushes, then a good one on the same connection: two
    ``telem_malformed`` events, and the good one still folds."""
    garbage = [j_transport.pack_obj(["not", "a", "dict"]),
               j_transport.pack_obj({"actor_id": 5, "snapshot": 42})]
    good = j_transport.pack_obj(_telem_payload(5, _snapshot(1)))
    counts = {}
    for name, pkg in PKGS.items():
        t = pkg.transport
        srv = pkg.ingest.IngestServer(queue.Queue(maxsize=4), address="127.0.0.1:0")
        srv.start()
        seq0 = _last_seq(pkg)
        try:
            sock = t.connect(srv.address)
            sock.settimeout(10)
            _hello(pkg, sock, 5)
            for payload in [*garbage, good]:
                t.send_frame(sock, t.K_TELEM, payload)
            assert _wait_for(lambda: pkg.registry.get_remote_mirror().sources())
            stale = pkg.registry.get_registry().get(
                "r2d2dpg_fleet_telem_staleness_seconds").labels(actor="5").value
            sock.close()
        finally:
            srv.stop()
        counts[name] = (len(_events(pkg, "telem_malformed", seq0, actor="5")),
                        [s[0] for s in pkg.registry.get_remote_mirror().sources()])
        assert stale >= 0.0
    assert counts["torch"] == counts["jax"] == (2, ["actor:5"])


# ------------------------------------------------------------ the shard fold
class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _shard_fold_script(pkg, clock):
    """HELLO epoch 1, fold, silence, reconnect under epoch 1, rejoin under
    epoch 2, fold the new incarnation; (sources, epochs, staleness) after
    each step."""
    ss = pkg.shard.RemoteShardSet(1, lambda sid: None,
                                  wire_config=pkg.wire.WireConfig())
    stale = lambda: ss._telem_staleness_s(0)  # noqa: E731
    out = []

    def record(step):
        out.append((step, pkg.registry.get_remote_mirror().sources(),
                    dict(ss._telem_epoch), stale(),
                    pkg.registry.get_registry().get(
                        "r2d2dpg_shard_telem_staleness_seconds").labels(shard="0").value))

    ss._arm_telem_staleness(0, 1)
    record("hello_epoch1")
    clock.t += 0.5
    ss._fold_shard_telem(0, j_transport.pack_obj(
        {"shard": 0, "epoch": 1, "host": "h", "t_wall": 1.0, "snapshot": _snapshot(3)}))
    record("fold_epoch1")
    clock.t += 4.0
    record("silent")
    ss._arm_telem_staleness(0, 1)  # a reconnect: the same incarnation
    record("reconnect_same_epoch")
    clock.t += 1.0
    ss._arm_telem_staleness(0, 2)  # an epoch-bumped rejoin
    record("rejoin_epoch2")
    clock.t += 0.25
    ss._fold_shard_telem(0, j_transport.pack_obj(
        {"shard": 0, "epoch": 2, "host": "h2", "t_wall": 2.0, "snapshot": _snapshot(4)}))
    record("fold_epoch2")
    return out, pkg.registry.get_registry().get(
        "r2d2dpg_shard_telem_frames_total").labels(shard="0").value


def test_shard_fold_and_epoch_rearm_equal_jax(fresh_obs, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    port = _shard_fold_script(PKGS["torch"], clock)
    clock.t = 1000.0
    ref = _shard_fold_script(PKGS["jax"], clock)
    assert port == ref
    steps = {s[0]: s for s in port[0]}
    assert steps["silent"][3] == 4.0  # the clock grows through silence
    assert steps["reconnect_same_epoch"][3] == 4.0  # kept by the same epoch
    assert steps["rejoin_epoch2"][3] == 0.0 and steps["rejoin_epoch2"][2] == {0: 2}
    key, labels, snap = steps["fold_epoch2"][1][0]
    assert key == "shard:0" and labels == {"shard": "0", "host": "h2"}
    assert len(steps["fold_epoch2"][1]) == 1 and port[1] == 2


def test_shard_malformed_telem_costs_one_event_each(fresh_obs):
    """Three TELEM pushes ahead of a reply (a non-dict, a wrong shard's
    claim, a snapshot that is not one): ``RemoteShard._recv`` drops each
    with one ``shard_telem_malformed`` event and returns the reply."""
    bad = [j_transport.pack_obj(["not", "a", "dict"]),
           j_transport.pack_obj({"shard": 1, "snapshot": {}}),
           j_transport.pack_obj({"shard": 0, "snapshot": 7})]
    ack = j_transport.pack_obj({"code": "ok", "applied": 0})
    got = {}
    for name, pkg in PKGS.items():
        t = pkg.transport
        ss = pkg.shard.RemoteShardSet(1, lambda sid: None,
                                      wire_config=pkg.wire.WireConfig())
        a, b = socket.socketpair()
        seq0 = _last_seq(pkg)
        try:
            for payload in bad:
                t.send_frame(b, t.K_TELEM, payload)
            t.send_frame(b, t.K_ACK, ack)
            recv = ss.shards[0]._recv
            kind, payload = recv(a) if name == "torch" else recv("sample", a)
        finally:
            a.close()
            b.close()
        got[name] = (kind, payload, len(_events(pkg, "shard_telem_malformed", seq0, shard=0)),
                     pkg.registry.get_remote_mirror().sources(), ss.telem_bytes_total)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == p_transport.K_ACK and got["torch"][2] == 3
    assert got["torch"][3] == []


# ------------------------------------------------------------ the push side
class _Count:
    def __init__(self):
        self.n = 0

    def inc(self, n=1):
        self.n += n


def _pushed_bytes(send):
    """The bytes ``send(sock)`` puts on a socket, read to EOF."""
    a, b = socket.socketpair()
    try:
        send(a)
        a.close()
        b.settimeout(5)
        buf = b""
        while True:
            chunk = b.recv(65536)
            if not chunk:
                return buf
            buf += chunk
    finally:
        a.close()
        b.close()


def test_actor_telem_frame_byte_equal_to_jax(monkeypatch):
    snap = _snapshot(9)
    monkeypatch.setattr(time, "time", lambda: 1.75e9)
    monkeypatch.setattr(socket, "gethostname", lambda: "actorhost")
    frames = {}
    for name, pkg in PKGS.items():
        monkeypatch.setattr(pkg.actor, "get_registry",
                            lambda: types.SimpleNamespace(snapshot=lambda: snap))
        stub = types.SimpleNamespace(
            telem_every=1.0, _telem_last=0.0, _obs_telem=_Count(),
            _obs_bytes_out=_Count(), actor_id=2,
            max_frame_bytes=p_transport.MAX_FRAME_BYTES)

        frames[name] = _pushed_bytes(
            lambda sock, stub=stub, pkg=pkg: pkg.actor.FleetActor._maybe_send_telem(
                stub, sock, force=True))
        assert stub._obs_telem.n == 1 and stub._obs_bytes_out.n == len(frames[name])
        # The cadence gate: not due again within telem_every.
        pkg.actor.FleetActor._maybe_send_telem(stub, None)
        assert stub._obs_telem.n == 1
    assert frames["torch"] == frames["jax"]
    assert frames["torch"][4] == p_transport.K_TELEM  # the kind byte


def _shard_registry(pkg):
    reg = pkg.registry.Registry()
    g = reg.gauge("r2d2dpg_replay_shard_occupancy", "occ", labelnames=("shard",))
    g.labels(shard="0").set(5)
    g.labels(shard="1").set(6)
    reg.counter("r2d2dpg_trace_shard_draw_total", "proc-wide").inc(3)
    reg.counter("r2d2dpg_fleet_bytes_in_total", "learner-owned").inc(2)
    reg.gauge("r2d2dpg_shard_telem_staleness_seconds", "fold",
              labelnames=("shard",)).labels(shard="0").set(9)
    return reg


@pytest.mark.parametrize("proc_wide", [True, False])
def test_shard_telem_frame_byte_equal_to_jax(monkeypatch, proc_wide):
    """The shard server's push: this shard's labelled cells only, the
    process-wide series from the ``telem_proc_wide`` server only, never
    the fold's own instruments or a learner-owned family."""
    monkeypatch.setattr(time, "time", lambda: 1.25e9)
    monkeypatch.setattr(socket, "gethostname", lambda: "shardhost")
    frames, snaps = {}, {}
    for name, pkg in PKGS.items():
        reg = _shard_registry(pkg)
        monkeypatch.setattr(pkg.shard, "get_registry", lambda reg=reg: reg)
        stub = types.SimpleNamespace(
            shard=types.SimpleNamespace(shard_id=0), epoch=2, telem_every=1.0,
            telem_proc_wide=proc_wide, _telem_last=0.0, _telem_lock=threading.Lock(),
            max_frame_bytes=p_transport.MAX_FRAME_BYTES)
        stub._telem_snapshot = types.MethodType(pkg.shard.ShardServer._telem_snapshot, stub)
        snaps[name] = stub._telem_snapshot()

        frames[name] = _pushed_bytes(
            lambda sock, stub=stub, pkg=pkg: pkg.shard.ShardServer._maybe_send_telem(
                stub, sock, force=True))
    assert frames["torch"] == frames["jax"]
    assert snaps["torch"] == snaps["jax"]
    snap = snaps["torch"]
    assert [s["labels"] for s in snap["r2d2dpg_replay_shard_occupancy"]["samples"]] == [
        {"shard": "0"}]
    assert ("r2d2dpg_trace_shard_draw_total" in snap) is proc_wide
    assert "r2d2dpg_fleet_bytes_in_total" not in snap
    assert "r2d2dpg_shard_telem_staleness_seconds" not in snap


# ------------------------------------------------------------ live e2e (port)
def test_two_actor_e2e_one_scrape_holds_both_actors(fresh_obs):
    """Two thread actors pushing TELEM every 0.05 s into a pendulum_tiny
    learner on the CPU: one scrape of the learner's /metrics carries both
    actors' labelled series and both staleness gauges."""
    from r2d2dpg_torch.configs import PENDULUM_TINY
    from r2d2dpg_torch.fleet import FleetActor, FleetConfig, FleetLearner

    trainer = PENDULUM_TINY.build("cpu")
    learner = FleetLearner(trainer, FleetConfig(num_actors=2, queue_depth=4,
                                                idle_timeout_s=60))
    address = learner.start()
    actors = [FleetActor(PENDULUM_TINY, actor_id=i, num_actors=2, address=address,
                         seed=0, telem_every=0.05, device="cpu") for i in range(2)]

    def actor_loop(a):
        try:
            a.run(max_phases=400)
        except Exception:  # noqa: BLE001 - the teardown cuts the socket
            pass

    threads = [threading.Thread(target=actor_loop, args=(a,), daemon=True)
               for a in actors]
    for t in threads:
        t.start()
    try:
        state = learner.run(6, log_every=0)
        # Both actors have pushed at least once after HELLO (forced).
        assert _wait_for(lambda: len(pobs.get_remote_mirror().sources()) == 2)
        ex = pobs.MetricsExporter(pobs.get_registry(), port=0, host="127.0.0.1",
                                  mirror=pobs.get_remote_mirror())
        try:
            text = urllib.request.urlopen(
                f"http://127.0.0.1:{ex.port}/metrics", timeout=10).read().decode()
        finally:
            ex.stop()
    finally:
        learner.close()
        for t in threads:
            t.join(timeout=30)
    assert int(state.train.step) == 6 * trainer.config.learner_steps
    host = socket.gethostname()
    for a in ("0", "1"):
        assert f'r2d2dpg_actor_phases_total{{actor="{a}",host="{host}"}}' in text, a
        assert f'r2d2dpg_actor_param_version{{actor="{a}",host="{host}"}}' in text, a
        assert f'r2d2dpg_fleet_telem_staleness_seconds{{actor="{a}"}}' in text, a
        assert f'r2d2dpg_fleet_telem_frames_total{{actor="{a}"}}' in text, a
    assert text.count("# TYPE r2d2dpg_actor_phases_total") == 1
