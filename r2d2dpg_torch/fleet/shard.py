"""The standalone replay shard tier: supervised shard processes.

Port of ``r2d2dpg_tpu/fleet/shard.py``.  ``--shard-procs N`` moves the
sampler path's replay shards (``replay/sharded.py``) out of the learner
into N supervised processes, so replay is its own failure domain (the
Ape-X separation of actors, replay and learner, PAPERS.md 1803.00933)::

    python -m r2d2dpg_torch.fleet.shard --shard-ids 0,1 --capacity 64 ...

    actors --SEQS--> learner ingest handlers --SEQS--> +--------------+
                       (accounting banked HERE,        | shard proc p |
                        re-routed on shard death)      |  ReplayShard |
    learner pull loop --SAMPLE_REQ-->                  |  (own ring,  |
                      <--BATCH {.., epoch}--           |   own epoch) |
                      --PRIO {.., epoch}-->            +--------------+

- **One listening socket per shard**, speaking the fleet's framed
  protocol (``fleet/transport.py``, ``fleet/wire.py`` payloads on the
  negotiated lane) with HELLO authentication and heartbeat/reap.
- **Two legs** per shard: the ingest handlers forward each actor's SEQS
  batches (the accounting deltas bank in the learner, so a dead shard
  loses only re-collectable experience) and the sampler pulls
  SAMPLE_REQ/BATCH and writes back PRIO over its own connection.
- **Graceful degradation**: a dead shard advertises 0, so the next quota
  draw renormalizes over the survivors, and its actors' traffic goes to
  the next live shard in ring order.
- **Epoch-fenced rejoin**: the supervisor (``supervisor.py``, role
  ``shard``) respawns a crashed process with a bumped ``--epoch``; the
  empty new incarnation stamps it into every BATCH and checks it on every
  PRIO, so handles from the previous incarnation (whose slot generations
  restart at zero) are ignored.

M shards live in N processes (M % N == 0, contiguous slices).  A shard
process runs numpy only: it is spawned with no card visible
(``CUDA_VISIBLE_DEVICES=""``), it makes no CUDA call, and it imports the
port only for the wire codec and the shard ring.

Direct data plane (``train --shard-direct 1``): an actor dials its shard
itself with a ``plane="data"`` HELLO and ships SEQS on that connection;
its bytes count only in ``r2d2dpg_fleet_data_bytes_{in,out}_total``.
With no SEQS crossing the learner, the sampler refreshes its view of
each shard with zero-quota SAMPLE_REQ pokes (``refresh_adverts``), which
draw nothing.

Chaos: ``--chaos-spec`` arms ``stall_shard`` (``fleet/chaos.py``
``ShardChaos``) on the SEQS frames this process absorbs; every reply
but the HELLO ack waits out the stall.

Not ported yet (ROADMAP.md): TELEM registry pushes (``--telem-every``);
the parser refuses that flag.
"""

from __future__ import annotations

import argparse
import hmac
import os
import signal
import socket
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from r2d2dpg_torch.fleet import chaos as fleet_chaos
from r2d2dpg_torch.fleet import transport, wire
from r2d2dpg_torch.fleet.supervisor import ActorSupervisor, SupervisorConfig
from r2d2dpg_torch.fleet.transport import (
    HEADER_BYTES,
    K_ACK,
    K_BATCH,
    K_BYE,
    K_HELLO,
    K_PRIO,
    K_SAMPLE_REQ,
    K_SEQS,
    MAX_FRAME_BYTES,
    READ_DEADLINE_S,
    FrameError,
    PeerDeadError,
    hello_auth_proof,
    pack_hello,
    pack_obj,
    recv_frame,
    recv_frame_heartbeat,
    send_frame,
    send_frame_parts,
    unpack_obj,
)
from r2d2dpg_torch.obs import (
    flight_event,
    get_flight_recorder,
    get_registry,
    set_flight_identity,
)
from r2d2dpg_torch.obs import trace as obs_trace
from r2d2dpg_torch.obs.quality import PROVENANCE_ABSENT, get_quality_plane
from r2d2dpg_torch.replay.arena import StagedSequences
from r2d2dpg_torch.replay.sharded import ReplayShard, actor_code, shard_instruments
from r2d2dpg_torch.utils.codes import OK, REFUSED_AUTH, REFUSED_WIRE


class ShardUnavailableError(Exception):
    """The shard's process is unreachable (dial refused, or a torn
    connection whose re-dial failed): the learner-side verdict that marks
    a shard dead.  ``not_up`` is a shard that has not published an
    address yet (its process is still starting): wait, not dead."""

    def __init__(self, msg: str, *, not_up: bool = False):
        super().__init__(msg)
        self.not_up = not_up


# ---------------------------------------------------------------- server
class ShardServer:
    """One replay shard behind one listening socket (the shard-process
    side), serving any number of authenticated connections, one handler
    thread each.

    Per connection (payloads on the negotiated lane; control acks are
    post-auth ``pack_obj`` dicts)::

        HELLO {auth?, wire...}     ->  ACK {code, shard, epoch, advert}
        SEQS {staged, actor}       ->  ACK {code, epoch, occupancy,
                                            scaled_sum, priority_sum,
                                            evictions}
        SAMPLE_REQ {quota}         ->  BATCH {seqs, slots/gens/probs,
                                              sum p^a, epoch}
                                       (or ACK {.., empty} on an empty ring)
        PRIO {slots/gens/p, epoch} ->  ACK {code, applied, stale, epoch}

    A ``SAMPLE_REQ`` of quota 0 is an advert poke: answered with an
    ``ACK {.., poke}``, no draw, the draw stream untouched.  Every reply
    after the HELLO ack passes the ``stall_shard`` gate (``chaos``).
    """

    def __init__(
        self,
        shard: ReplayShard,
        *,
        address: str = "127.0.0.1:0",
        epoch: int = 0,
        seed: int = 0,
        wire_config: Optional[wire.WireConfig] = None,
        max_frame_bytes: int = MAX_FRAME_BYTES,
        read_deadline_s: float = READ_DEADLINE_S,
        auth_token: Optional[str] = None,
        chaos: Optional[fleet_chaos.ShardChaos] = None,
    ):
        self.shard = shard
        self.epoch = int(epoch)
        self.chaos = chaos
        self._request_address = address
        self.wire_config = (wire_config or wire.WireConfig()).validate()
        self.max_frame_bytes = max_frame_bytes
        self.read_deadline_s = read_deadline_s
        self.auth_token = auth_token
        # Within-shard draws come from THIS incarnation's stream, seeded by
        # (seed, shard, epoch): a restarted shard never replays its
        # predecessor's draws against a fresh ring.
        self._rng = np.random.default_rng((int(seed), int(shard.shard_id), int(epoch)))
        self.address: Optional[str] = None
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._handlers: List[threading.Thread] = []
        self._conns: Dict[int, socket.socket] = {}
        self._conn_seq = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        sid = str(shard.shard_id)
        reg = get_registry()
        self._obs_stale_prio = reg.counter(
            "r2d2dpg_shard_stale_epoch_prio_total",
            "PRIO write-back frames ignored because their epoch named a "
            "previous incarnation of this shard (the rejoin fence)",
            labelnames=("shard",),
        ).labels(shard=sid)
        self._obs_peer_dead = reg.counter(
            "r2d2dpg_shard_peer_dead_total",
            "shard-side connections reaped after a silent heartbeat "
            "deadline (the peer answered neither frames nor the PING)",
            labelnames=("shard",),
        ).labels(shard=sid)
        # Bytes of connections whose HELLO said plane="data" (actors
        # shipping SEQS here directly), and only those.
        self._obs_data_in = reg.counter(
            "r2d2dpg_fleet_data_bytes_in_total",
            "bytes received on direct data-plane connections",
            labelnames=("plane",),
        )
        self._obs_data_out = reg.counter(
            "r2d2dpg_fleet_data_bytes_out_total",
            "bytes sent on direct data-plane connections",
            labelnames=("plane",),
        )
        psum, occ, evict = shard_instruments()
        psum.labels(shard=sid).set_fn(shard.priority_sum)
        occ.labels(shard=sid).set_fn(shard.occupancy)
        if shard._evict_cb is None:
            shard._evict_cb = evict.labels(shard=sid).inc
        if shard._evict_unsampled_cb is None:
            qplane = get_quality_plane()
            shard._evict_unsampled_cb = (
                lambda evicted, unsampled, _sid=shard.shard_id: (
                    qplane.note_evictions(_sid, evicted, unsampled)))

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ShardServer":
        if self._listener is not None:
            raise RuntimeError("shard server already started")
        family, target = transport.parse_address(self._request_address)
        sock = socket.socket(family, socket.SOCK_STREAM)
        if family == socket.AF_INET:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind(target)
        sock.listen(32)
        if family == socket.AF_INET:
            host, port = sock.getsockname()[:2]
            self.address = f"{host}:{port}"
        else:
            self.address = f"unix:{target}"
        self._listener = sock
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"shard{self.shard.shard_id}-accept",
            daemon=True)
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._listener is not None:
            for fn in (lambda: self._listener.shutdown(socket.SHUT_RDWR),
                       self._listener.close):
                try:
                    fn()
                except OSError:
                    pass
        with self._lock:
            conns = list(self._conns.values())
        for conn in conns:
            # SHUT_RDWR first: close() alone does not wake a blocked recv.
            for fn in (lambda c=conn: c.shutdown(socket.SHUT_RDWR), conn.close):
                try:
                    fn()
                except OSError:
                    pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
        for t in list(self._handlers):
            t.join(timeout=5)

    # ----------------------------------------------------------- connection
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            if self._stop.is_set():
                try:
                    conn.close()
                except OSError:
                    pass
                return
            transport.configure_socket(conn)
            conn.settimeout(self.read_deadline_s)
            with self._lock:
                self._conn_seq += 1
                ident = self._conn_seq
                self._conns[ident] = conn
            self._handlers = [t for t in self._handlers if t.is_alive()]
            t = threading.Thread(
                target=self._handle, args=(ident, conn),
                name=f"shard{self.shard.shard_id}-conn{ident}", daemon=True)
            self._handlers.append(t)
            t.start()

    def _gate(self) -> None:
        if self.chaos is not None:
            self.chaos.gate()

    def _advert(self, code: str = OK) -> Dict[str, Any]:
        """The state advertisement riding every control ack: the quota
        weight (``scaled_sum``), the raw priority sum, occupancy and the
        cumulative ring evictions."""
        s = self.shard
        return {
            "code": code,
            "shard": s.shard_id,
            "epoch": self.epoch,
            "occupancy": s.occupancy(),
            "scaled_sum": s.scaled_sum(),
            "priority_sum": s.priority_sum(),
            "evictions": s.evictions_total,
        }

    def _handle(self, ident: int, conn: socket.socket) -> None:
        peer = "?"
        unpacker = wire.TreeUnpacker(max_frame_bytes=self.max_frame_bytes)
        batch_packer = wire.TreePacker(self.wire_config,
                                       max_frame_bytes=self.max_frame_bytes)
        try:
            kind, payload = recv_frame(conn, max_frame_bytes=self.max_frame_bytes)
            if kind != K_HELLO:
                raise FrameError(f"expected HELLO, got kind {kind}")
            hello = transport.unpack_hello(payload)
            peer = str(hello.get("actor_id", "?"))
            if self.auth_token is not None:
                # The proof is checked before negotiation or any shard state.
                want = hello_auth_proof(self.auth_token)
                got = str(hello.get("auth", ""))
                if not hmac.compare_digest(want, got):
                    flight_event("shard_auth_refused", peer=peer)
                    send_frame(conn, K_ACK, pack_obj(  # wire-lint: control
                        {"code": REFUSED_AUTH, "epoch": self.epoch}))
                    return
            # An actor's direct leg says plane="data" at HELLO: its bytes
            # land only in the data-plane counters.
            count_in = count_out = lambda n: None  # noqa: E731
            data_plane = str(hello.get("plane", "")) == "data"
            if data_plane:
                count_in = self._obs_data_in.labels(plane="data").inc
                count_out = self._obs_data_out.labels(plane="data").inc
                count_in(HEADER_BYTES + len(payload))
            mismatch = wire.check_negotiation(hello, self.wire_config)
            if mismatch is not None:
                flight_event("shard_wire_refused", peer=peer, reason=mismatch)
                send_frame(conn, K_ACK, pack_obj(  # wire-lint: control
                    {"code": REFUSED_WIRE, "epoch": self.epoch, "reason": mismatch}))
                return
            count_out(send_frame(
                conn, K_ACK, pack_obj(self._advert())))  # wire-lint: control
            while not self._stop.is_set():
                kind, payload = recv_frame_heartbeat(
                    conn, max_frame_bytes=self.max_frame_bytes,
                    bytes_in=count_in, bytes_out=count_out)
                count_in(HEADER_BYTES + len(payload))
                if kind == K_BYE:
                    return
                if kind == K_SEQS:
                    msg = unpacker.unpack(payload)
                    staged: StagedSequences = msg["staged"]
                    if data_plane:
                        # The identity this connection's HELLO bound; the
                        # frame body's claim is ignored.
                        code = actor_code(peer)
                    else:
                        # The learner stamped ``actor`` from its own
                        # HELLO-authenticated ingest connection.
                        fwd = msg.get("actor")
                        code = (None if fwd is None
                                or int(fwd) == PROVENANCE_ABSENT else int(fwd))
                    self.shard.add(staged.seq, staged.priorities,
                                   behavior=staged.behavior_version,
                                   collect=staged.collect_id, actor=code)
                    if self.chaos is not None:
                        # Armed before the gate: the arming frame's own
                        # ack is already stalled.
                        self.chaos.on_seqs_frame()
                    self._gate()
                    count_out(send_frame(
                        conn, K_ACK, pack_obj(self._advert())))  # wire-lint: control
                elif kind == K_SAMPLE_REQ:
                    req = wire.unpack_sample_req(unpacker.unpack(payload))
                    # A sampled REQ's sidecar carries the trace id; its
                    # encode-end stamp is read before the reply pack
                    # overwrites it in place.
                    tr = unpacker.last_trace
                    t_recv = time.time()
                    t_req_encoded = tr.t_encode_end if tr is not None else 0.0
                    if req["shard"] != self.shard.shard_id:
                        raise FrameError(
                            f"SAMPLE_REQ for shard {req['shard']} on shard "
                            f"{self.shard.shard_id}'s socket")
                    if int(req["quota"]) <= 0:
                        # An advert poke (the direct data plane's absorb
                        # gate): no draw, no rng touch.
                        self._gate()
                        send_frame(conn, K_ACK, pack_obj(  # wire-lint: control
                            {**self._advert(), "poke": True}))
                        continue
                    try:
                        s = self.shard.sample(req["quota"], self._rng)
                    except ValueError:
                        # An empty ring (a stale quota weight met a restarted
                        # shard): an empty-marked advert, never a torn
                        # connection that would read as a dead process.
                        self._gate()
                        send_frame(conn, K_ACK, pack_obj(  # wire-lint: control
                            {**self._advert(), "empty": True}))
                        continue
                    t_draw_end = time.time()
                    self._gate()
                    send_frame_parts(
                        conn, K_BATCH,
                        wire.pack_shard_batch(
                            batch_packer,
                            req_id=req["req_id"],
                            shard=self.shard.shard_id,
                            staged=StagedSequences(seq=s.seq, priorities=None),
                            slots=s.slots,
                            gens=s.gens,
                            probs=s.probs,
                            priority_sum=self.shard.scaled_sum(),
                            occupancy=self.shard.occupancy(),
                            epoch=self.epoch,
                            behavior=s.behavior,
                            collect=s.collect,
                            actors=s.actors,
                            trace=tr,
                        ),
                        max_frame_bytes=self.max_frame_bytes,
                    )
                    if tr is not None:
                        # After the send: a torn exchange leaves no chain.
                        # batch_encode spans the stall gate: a wedged shard
                        # is a fat batch_encode on the timeline.
                        t_sent = time.time()
                        attrs = {"shard": self.shard.shard_id, "epoch": self.epoch}
                        obs_trace.record_hop("req_receive", t_req_encoded, t_recv,
                                             tr.trace_id, **attrs)
                        obs_trace.record_hop("shard_draw", t_recv, t_draw_end,
                                             tr.trace_id, draws=int(req["quota"]),
                                             **attrs)
                        obs_trace.record_hop("batch_encode", t_draw_end, t_sent,
                                             tr.trace_id, **attrs)
                elif kind == K_PRIO:
                    upd = wire.unpack_prio_update(unpacker.unpack(payload))
                    if upd["shard"] != self.shard.shard_id:
                        raise FrameError(
                            f"PRIO for shard {upd['shard']} on shard "
                            f"{self.shard.shard_id}'s socket")
                    stale = upd["epoch"] != self.epoch
                    if stale:
                        # The rejoin fence: a verdict about a previous
                        # incarnation's ring never touches this one.
                        flight_event("stale_epoch_prio_ignored",
                                     shard=self.shard.shard_id,
                                     got_epoch=upd["epoch"], epoch=self.epoch,
                                     entries=int(upd["slots"].shape[0]))
                        self._obs_stale_prio.inc()
                        applied = 0
                    else:
                        applied = self.shard.update_priorities(
                            upd["slots"], upd["gens"], upd["priorities"])
                    self._gate()
                    send_frame(conn, K_ACK, pack_obj(  # wire-lint: control
                        {"code": OK, "applied": int(applied), "stale": bool(stale),
                         "epoch": self.epoch}))
                else:
                    raise FrameError(f"unexpected frame kind {kind}")
        except PeerDeadError as e:
            if not self._stop.is_set():
                flight_event("shard_peer_dead", shard=self.shard.shard_id,
                             peer=peer, error=str(e))
                self._obs_peer_dead.inc()
        except (FrameError, OSError, ValueError) as e:
            if not self._stop.is_set():
                flight_event("shard_conn_error", shard=self.shard.shard_id,
                             peer=peer, error=f"{type(e).__name__}: {e}")
        finally:
            with self._lock:
                self._conns.pop(ident, None)
            try:
                conn.close()
            except OSError:
                pass


# ------------------------------------------------------- learner-side client
class RemoteShard:
    """Learner-side client of ONE out-of-process shard: two legs (the
    ingest handlers' shared SEQS leg and the sampler's SAMPLE_REQ/BATCH/
    PRIO leg, each behind its own lock), the epoch learned at HELLO, and
    the shard's last advertisement.  A torn connection is re-dialed once
    inline; a refused dial raises ``ShardUnavailableError``."""

    def __init__(
        self,
        shard_id: int,
        address_fn: Callable[[], Optional[str]],
        *,
        wire_config: wire.WireConfig,
        auth_token: Optional[str],
        max_frame_bytes: int,
        read_deadline_s: float,
        on_bytes: Optional[Callable[[str, int], None]] = None,
    ):
        self.shard_id = int(shard_id)
        self.address_fn = address_fn
        self.wire_config = wire_config
        self.auth_token = auth_token
        self.max_frame_bytes = max_frame_bytes
        self.read_deadline_s = read_deadline_s
        self._on_bytes = on_bytes or (lambda leg, n: None)
        self.epoch = 0
        self.alive = True  # optimistic until a dial fails
        self.ever_connected = False
        # The last advertisement (SEQS acks and BATCH frames refresh it):
        # the quota weight and the absorb gate's occupancy.
        self.scaled_sum = 0.0
        self.priority_sum = 0.0
        self.occupancy = 0
        # ``evictions`` is the live incarnation's advertised count;
        # ``evictions_prior`` banks dead incarnations' totals at rejoin, so
        # the tier-wide count never decreases.
        self.evictions = 0
        self.evictions_prior = 0
        self._on_evictions: Callable[[int], None] = lambda n: None
        self._legs: Dict[str, Optional[socket.socket]] = {"ingest": None, "sample": None}
        self._packers: Dict[str, Optional[wire.TreePacker]] = {"ingest": None, "sample": None}
        self._unpackers: Dict[str, Optional[wire.TreeUnpacker]] = {
            "ingest": None, "sample": None}
        self._locks = {"ingest": threading.Lock(), "sample": threading.Lock()}

    # ---------------------------------------------------------------- conns
    def _dial(self, leg: str) -> None:
        addr = self.address_fn()
        if addr is None:
            raise ShardUnavailableError(
                f"shard {self.shard_id}: no address published yet",
                not_up=not self.ever_connected)
        try:
            sock = transport.connect(addr, timeout=5.0,
                                     read_deadline_s=self.read_deadline_s)
        except OSError as e:
            raise ShardUnavailableError(f"shard {self.shard_id} at {addr}: {e}")
        try:
            hello = {"actor_id": f"learner-{leg}", "role": leg,
                     **wire.negotiation_fields(self.wire_config)}
            if self.auth_token is not None:
                hello["auth"] = hello_auth_proof(self.auth_token)
            self._on_bytes(leg, send_frame(sock, K_HELLO, pack_hello(hello),
                                           max_frame_bytes=self.max_frame_bytes))
            kind, payload = recv_frame(sock, max_frame_bytes=self.max_frame_bytes)
            self._on_bytes(leg, HEADER_BYTES + len(payload))
            ack = unpack_obj(payload)  # wire-lint: control
            if ack.get("code") != OK:
                # The learner spawned this shard with its own lane and
                # token: a refusal is misconfiguration, never retried.
                raise RuntimeError(
                    f"shard {self.shard_id} refused HELLO: {ack.get('code')}"
                    f" ({ack.get('reason')})")
            self._apply_advert(ack)
            self.epoch = int(ack.get("epoch", 0))
        except (FrameError, OSError) as e:
            try:
                sock.close()
            except OSError:
                pass
            raise ShardUnavailableError(f"shard {self.shard_id} HELLO failed: {e}")
        self._legs[leg] = sock
        self.ever_connected = True
        # Wire state lives and dies with the socket.
        self._packers[leg] = wire.TreePacker(self.wire_config,
                                             max_frame_bytes=self.max_frame_bytes)
        self._unpackers[leg] = wire.TreeUnpacker(max_frame_bytes=self.max_frame_bytes)

    def _drop_leg(self, leg: str) -> None:
        sock = self._legs[leg]
        self._legs[leg] = None
        if sock is not None:
            for fn in (lambda: sock.shutdown(socket.SHUT_RDWR), sock.close):
                try:
                    fn()
                except OSError:
                    pass

    def drop_connections(self) -> int:
        """Abruptly close both legs (a partition).  Returns how many live
        legs were dropped."""
        dropped = 0
        for leg in ("ingest", "sample"):
            with self._locks[leg]:
                if self._legs[leg] is not None:
                    dropped += 1
                self._drop_leg(leg)
        return dropped

    def close(self) -> None:
        for leg in ("ingest", "sample"):
            with self._locks[leg]:
                sock = self._legs[leg]
                if sock is not None:
                    try:
                        send_frame(sock, K_BYE, b"")  # wire-lint: control
                    except OSError:
                        pass
                self._drop_leg(leg)

    def _apply_advert(self, ack: Dict[str, Any]) -> None:
        self.scaled_sum = float(ack.get("scaled_sum", self.scaled_sum))
        self.priority_sum = float(ack.get("priority_sum", self.priority_sum))
        self.occupancy = int(ack.get("occupancy", self.occupancy))
        ev = int(ack.get("evictions", self.evictions))
        if ev > self.evictions:
            self._on_evictions(ev - self.evictions)
            self.evictions = ev

    def _recv(self, sock) -> Tuple[int, bytes]:
        return recv_frame_heartbeat(sock, max_frame_bytes=self.max_frame_bytes)

    def _exchange(self, leg: str, do_exchange):
        """One send/recv exchange on a leg, re-dialing a torn connection
        once (at least once on the SEQS leg: a duplicate add is
        re-collectable experience).  Raises ``ShardUnavailableError``
        when the process is unreachable."""
        with self._locks[leg]:
            for attempt in (0, 1):
                if self._legs[leg] is None:
                    self._dial(leg)
                try:
                    return do_exchange(self._legs[leg], self._packers[leg],
                                       self._unpackers[leg])
                except (FrameError, OSError) as e:
                    self._drop_leg(leg)
                    if attempt == 1 or isinstance(e, PeerDeadError):
                        raise ShardUnavailableError(
                            f"shard {self.shard_id} {leg} leg: "
                            f"{type(e).__name__}: {e}")

    # ----------------------------------------------------------------- legs
    def forward_seqs(self, staged: StagedSequences,
                     actor: Optional[int] = None) -> Dict[str, Any]:
        """SEQS leg: forward one staged batch; returns the shard's ack
        (already applied).  ``actor`` is the code of the actor the
        learner's ingest handler authenticated, always sent (the sentinel
        when unknown) so the leg's cached schema never changes."""

        def do(sock, packer, unpacker):
            n = send_frame_parts(
                sock, K_SEQS,
                packer.pack({"staged": staged,
                             "actor": int(PROVENANCE_ABSENT if actor is None else actor)}),
                max_frame_bytes=self.max_frame_bytes)
            self._on_bytes("ingest", n)
            kind, payload = self._recv(sock)
            self._on_bytes("ingest", HEADER_BYTES + len(payload))
            if kind != K_ACK:
                raise FrameError(f"expected ACK, got kind {kind}")
            ack = unpack_obj(payload)  # wire-lint: control
            self._apply_advert(ack)
            self.epoch = int(ack.get("epoch", self.epoch))
            return ack

        return self._exchange("ingest", do)

    def sample(self, quota: int, req_id: int, trace=None) -> Optional[Dict[str, Any]]:
        """Sampler leg: one SAMPLE_REQ/BATCH exchange.  A BATCH whose epoch
        is not the connection's is a stale in-flight batch of a previous
        incarnation: dropped with a flight event and raised.  Returns
        ``None`` for an empty shard (its advert zeroes the weight)."""

        def do(sock, packer, unpacker):
            n = send_frame_parts(
                sock, K_SAMPLE_REQ,
                wire.pack_sample_req(packer, req_id=req_id, shard=self.shard_id,
                                     quota=int(quota), trace=trace),
                max_frame_bytes=self.max_frame_bytes)
            self._on_bytes("sample", n)
            kind, payload = self._recv(sock)
            self._on_bytes("sample", HEADER_BYTES + len(payload))
            if kind == K_ACK:
                ack = unpack_obj(payload)  # wire-lint: control
                if ack.get("empty"):
                    self._apply_advert(ack)
                    return None
                raise FrameError("unexpected non-empty ACK to SAMPLE_REQ")
            if kind != K_BATCH:
                raise FrameError(f"expected BATCH, got kind {kind}")
            resp = wire.unpack_shard_batch(unpacker.unpack(payload))
            if resp["shard"] != self.shard_id:
                raise FrameError(
                    f"BATCH for shard {resp['shard']} on shard {self.shard_id}'s leg")
            if resp["epoch"] != self.epoch:
                flight_event("stale_epoch_batch_ignored", shard=self.shard_id,
                             got_epoch=resp["epoch"], epoch=self.epoch)
                raise FrameError(
                    f"BATCH epoch {resp['epoch']} != connection epoch {self.epoch}")
            self.scaled_sum = float(resp["priority_sum"])
            self.occupancy = int(resp["occupancy"])
            return resp

        return self._exchange("sample", do)

    def refresh_advert(self) -> Dict[str, Any]:
        """Sampler leg: one zero-quota SAMPLE_REQ for the advert on its
        ack.  Under the direct data plane no SEQS ack crosses the learner,
        so the absorb gate polls the shard's occupancy with this (the
        shard draws nothing)."""

        def do(sock, packer, unpacker):
            n = send_frame_parts(
                sock, K_SAMPLE_REQ,
                wire.pack_sample_req(packer, req_id=0, shard=self.shard_id,
                                     quota=0, trace=None),
                max_frame_bytes=self.max_frame_bytes)
            self._on_bytes("sample", n)
            kind, payload = self._recv(sock)
            self._on_bytes("sample", HEADER_BYTES + len(payload))
            if kind != K_ACK:
                raise FrameError(
                    f"expected ACK to zero-quota SAMPLE_REQ, got kind {kind}")
            ack = unpack_obj(payload)  # wire-lint: control
            self._apply_advert(ack)
            self.epoch = int(ack.get("epoch", self.epoch))
            return ack

        return self._exchange("sample", do)

    def write_back(self, slots: np.ndarray, gens: np.ndarray,
                   priorities: np.ndarray, *, epoch: int) -> Dict[str, Any]:
        """Sampler leg: one PRIO/ACK exchange (the shard applies only
        handles of its own epoch and current generations)."""

        def do(sock, packer, unpacker):
            n = send_frame_parts(
                sock, K_PRIO,
                wire.pack_prio_update(packer, shard=self.shard_id, slots=slots,
                                      gens=gens, priorities=priorities, epoch=epoch),
                max_frame_bytes=self.max_frame_bytes)
            self._on_bytes("sample", n)
            kind, payload = self._recv(sock)
            self._on_bytes("sample", HEADER_BYTES + len(payload))
            if kind != K_ACK:
                raise FrameError(f"expected ACK, got kind {kind}")
            return unpack_obj(payload)  # wire-lint: control

        return self._exchange("sample", do)


class RemoteShardSet:
    """The out-of-process tier behind the loopback ``ShardSet``'s interface
    (``route``/``add``/``pop_stats``/``occupancy_total``/``scaled_sums``/
    ``evictions_total``), plus liveness: per-shard alive/epoch state,
    re-routing of a dead shard's actors to the next live shard in ring
    order, advertisement-backed quota weights (a dead shard weighs 0, so
    ``shard_quotas`` renormalizes over the survivors), rate-limited
    epoch-fenced rejoin, and ``partition``.  The accounting deltas bank
    here, in the learner, whatever happens to a shard."""

    def __init__(
        self,
        num_shards: int,
        address_fn: Callable[[int], Optional[str]],
        *,
        wire_config: wire.WireConfig,
        auth_token: Optional[str] = None,
        max_frame_bytes: int = MAX_FRAME_BYTES,
        read_deadline_s: float = READ_DEADLINE_S,
        rejoin_interval_s: float = 0.5,
    ):
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        self._address_fn = address_fn
        self._stop = threading.Event()
        self.rejoin_interval_s = rejoin_interval_s
        self._rejoin_last: Dict[int, float] = {}
        self._rejoin_refused: set = set()
        self._stats_lock = threading.Lock()
        self._stats = {"env_steps_delta": 0.0, "ep_return_sum": 0.0, "ep_count": 0.0}
        # Liveness transitions and byte/death counters are touched by N
        # handler threads and the sampler: one lock keeps _mark_dead
        # single-shot and the counters lossless.
        self._live_lock = threading.Lock()
        # One rejoiner at a time, so one rejoin is recorded once.
        self._rejoin_lock = threading.Lock()
        self.sample_bytes_total = 0
        self.forward_bytes_total = 0
        self.deaths_total = 0
        self.rejoins_total = 0
        self._on_sample_bytes: Callable[[int], None] = lambda n: None
        reg = get_registry()
        self._obs_deaths = reg.counter(
            "r2d2dpg_shard_deaths_total",
            "shard processes detected dead by the learner (dial refused "
            "after a torn connection); each one renormalizes the quotas "
            "over the survivors",
            labelnames=("shard",),
        )
        self._obs_rejoins = reg.counter(
            "r2d2dpg_shard_rejoins_total",
            "dead shards that rejoined under a bumped epoch (supervisor "
            "restart + fresh HELLO)",
            labelnames=("shard",),
        )
        self._obs_renorms = reg.counter(
            "r2d2dpg_shard_quota_renorms_total",
            "quota renormalizations over surviving shards (one per shard death)",
        )
        psum, occ, evict = shard_instruments()
        self.shards = [
            RemoteShard(
                i, (lambda sid=i: address_fn(sid)),
                wire_config=wire_config, auth_token=auth_token,
                max_frame_bytes=max_frame_bytes, read_deadline_s=read_deadline_s,
                on_bytes=self._count_bytes)
            for i in range(num_shards)
        ]
        for i, s in enumerate(self.shards):
            psum.labels(shard=str(i)).set_fn(
                lambda sh=s: sh.priority_sum if sh.alive else 0.0)
            occ.labels(shard=str(i)).set_fn(
                lambda sh=s: float(sh.occupancy) if sh.alive else 0.0)
            s._on_evictions = evict.labels(shard=str(i)).inc

    # ------------------------------------------------------------- plumbing
    def _count_bytes(self, leg: str, n: int) -> None:
        if leg == "sample":
            with self._live_lock:
                self.sample_bytes_total += n
            self._on_sample_bytes(n)
        else:
            with self._live_lock:
                self.forward_bytes_total += n

    def bind_sample_bytes(self, fn: Callable[[int], None]) -> None:
        """The sampler's byte counter rides every sampler-leg frame
        (REQ/BATCH/PRIO and their acks, headers included)."""
        self._on_sample_bytes = fn

    def close(self) -> None:
        self._stop.set()
        for s in self.shards:
            s.close()

    # ------------------------------------------------------------- liveness
    def _mark_dead(self, shard_id: int, error: str) -> None:
        s = self.shards[shard_id]
        with self._live_lock:
            if not s.alive:
                return  # another thread already recorded this death
            s.alive = False
            self.deaths_total += 1
        s.drop_connections()
        self._obs_deaths.labels(shard=str(shard_id)).inc()
        flight_event("shard_dead", shard=shard_id, error=error)
        # The dead shard weighs 0 from here: the next quota draw
        # redistributes its share over the survivors.
        self._obs_renorms.inc()
        flight_event("shard_quota_renorm", shard=shard_id,
                     survivors=[x.shard_id for x in self.shards if x.alive])

    def maybe_rejoin(self) -> None:
        """Rate-limited reconnection of dead shards: a restarted
        incarnation publishes a fresh address and answers HELLO with its
        bumped epoch; from then on it is live, its empty ring advertises 0
        until traffic refills it, and its actors route home again."""
        if not self._rejoin_lock.acquire(blocking=False):
            return
        try:
            self._maybe_rejoin_locked()
        finally:
            self._rejoin_lock.release()

    def _maybe_rejoin_locked(self) -> None:
        now = time.monotonic()
        for s in self.shards:
            if s.alive or s.shard_id in self._rejoin_refused:
                continue
            if now - self._rejoin_last.get(s.shard_id, 0.0) < self.rejoin_interval_s:
                continue
            self._rejoin_last[s.shard_id] = now
            old_epoch = s.epoch
            try:
                with s._locks["sample"]:
                    if s._legs["sample"] is None:
                        s._dial("sample")
            except ShardUnavailableError:
                continue
            except RuntimeError as e:
                # A refused HELLO is misconfiguration: give this shard's
                # rejoin up loudly instead of spinning.
                self._rejoin_refused.add(s.shard_id)
                flight_event("shard_rejoin_refused", shard=s.shard_id, error=str(e))
                continue
            if s.epoch != old_epoch:
                # A restarted incarnation comes back EMPTY: never credit the
                # dead ring's sums to it; bank its evictions.
                s.scaled_sum = 0.0
                s.priority_sum = 0.0
                s.occupancy = 0
                s.evictions_prior += s.evictions
                s.evictions = 0
            with self._live_lock:
                s.alive = True
            self.rejoins_total += 1
            self._obs_rejoins.labels(shard=str(s.shard_id)).inc()
            flight_event("shard_rejoin", shard=s.shard_id, epoch=s.epoch,
                         previous_epoch=old_epoch)

    def partition(self, shard_id: int) -> bool:
        """Drop both legs' connections to one shard (a network partition,
        not a restart: data and epoch survive, both legs reconnect
        lazily).  True when a live connection was dropped."""
        return self.shards[int(shard_id)].drop_connections() > 0

    # --------------------------------------------------- ShardSet interface
    @property
    def num_shards(self) -> int:
        return len(self.shards)

    def route(self, actor_id: Any) -> int:
        """The actor's home shard when alive, else the next live shard in
        ring order (the home shard when all are dead)."""
        from r2d2dpg_torch.fleet.sampler import shard_for_actor

        home = shard_for_actor(actor_id, len(self.shards))
        for off in range(len(self.shards)):
            sid = (home + off) % len(self.shards)
            if self.shards[sid].alive:
                return sid
        return home

    def assignment_for(self, actor_id: Any) -> Optional[Dict[str, Any]]:
        """The direct data plane's advert for one actor: its routed shard,
        that shard's published address and the epoch the learner last
        saw; None while the shard is dead or has no address (the actor
        keeps forwarding).  The actor's own data HELLO is the real fence."""
        sid = self.route(actor_id)
        s = self.shards[sid]
        if not s.alive:
            return None
        try:
            addr = self._address_fn(sid)
        except Exception:  # noqa: BLE001 - advisory path, never fatal
            return None
        if addr is None:
            return None
        return {"shard": sid, "address": addr, "epoch": s.epoch}

    def bank_stats(self, msg: Dict[str, Any]) -> None:
        """Bank one message's accounting deltas learner-side: ``add``
        banks the forwarded path's, the ingest server's K_STATS branch the
        direct path's."""
        with self._stats_lock:
            for k in self._stats:
                self._stats[k] += float(msg.get(k, 0.0))

    def add(self, shard_id: int, msg: Dict[str, Any]) -> int:
        """One SEQS message into the tier (ingest-handler side): bank the
        accounting first, then forward the experience to the routed shard,
        re-routing on failure and waiting out a tier that is all dead (the
        actor's ack wait is the backpressure) until ``close``.  Returns B."""
        staged: StagedSequences = msg["staged"]
        n = int(np.shape(staged.seq.reward)[0])
        self.bank_stats(msg)
        actor = msg.get("actor_id")
        code = None if actor is None else actor_code(actor)
        target = int(shard_id)
        while not self._stop.is_set():
            if not self.shards[target].alive:
                target = self.route(msg.get("actor_id", target))
            if not self.shards[target].alive:
                self.maybe_rejoin()
                time.sleep(0.1)
                continue
            try:
                self.shards[target].forward_seqs(staged, actor=code)
                return n
            except ShardUnavailableError as e:
                if e.not_up:
                    # The shard process has not published its address yet:
                    # wait, never a death verdict.
                    time.sleep(0.05)
                    continue
                self._mark_dead(target, str(e))
        return n  # closing: the run is over, the experience is droppable

    def pop_stats(self) -> Dict[str, float]:
        with self._stats_lock:
            out = dict(self._stats)
            for k in self._stats:
                self._stats[k] = 0.0
        return out

    def refresh_adverts(self) -> int:
        """Zero-quota advert pokes across the live shards (the direct data
        plane's absorb gate: no forward ack refreshes the learner's view).
        A shard not up yet is waited out as ``add`` does; an unreachable
        shard that was up is marked dead here.  Returns how many adverts
        were refreshed."""
        refreshed = 0
        for s in self.shards:
            if not s.alive:
                continue
            try:
                s.refresh_advert()
                refreshed += 1
            except ShardUnavailableError as e:
                if not e.not_up:
                    self._mark_dead(s.shard_id, str(e))
        return refreshed

    def occupancy_total(self) -> int:
        return sum(s.occupancy for s in self.shards if s.alive)

    def scaled_sums(self) -> np.ndarray:
        """Advertised quota weights; a dead shard weighs 0."""
        return np.asarray([s.scaled_sum if s.alive else 0.0 for s in self.shards],
                          np.float64)

    def evictions_total(self) -> int:
        return sum(s.evictions_prior + s.evictions for s in self.shards)


# ---------------------------------------------------------------- the tier
class ShardProcTier:
    """Learner-side owner of the standalone tier (``--shard-procs N``): the
    supervisor (role ``shard``), the per-process address files, the
    per-incarnation epochs, and the ``RemoteShardSet`` the ingest server
    and the sampler plug into.  M shards live in N processes as
    contiguous slices; an epoch is the slot's incarnation count, passed on
    argv and learned back from the HELLO ack."""

    def __init__(
        self,
        *,
        num_shards: int,
        num_procs: int,
        capacity_per_shard: int,
        alpha: float,
        prioritized: bool,
        dirpath: str,
        seed: int = 0,
        wire_config: Optional[wire.WireConfig] = None,
        auth_token: Optional[str] = None,
        max_frame_bytes: int = MAX_FRAME_BYTES,
        heartbeat_s: float = READ_DEADLINE_S,
        chaos_spec: Optional[str] = None,
        flight_dir: Optional[str] = None,
        supervisor_config: Optional[SupervisorConfig] = None,
    ):
        if num_procs < 1:
            raise ValueError("num_procs must be >= 1")
        if num_shards % num_procs:
            raise ValueError(
                f"{num_shards} shards not divisible by {num_procs} shard "
                f"processes (contiguous equal slices)")
        self.num_shards = num_shards
        self.num_procs = num_procs
        self.capacity_per_shard = capacity_per_shard
        self.alpha = alpha
        self.prioritized = prioritized
        self.dirpath = os.path.abspath(dirpath)
        self.seed = seed
        self.wire_config = (wire_config or wire.WireConfig()).validate()
        self.auth_token = auth_token
        self.max_frame_bytes = max_frame_bytes
        self.heartbeat_s = heartbeat_s
        self.chaos_spec = chaos_spec  # forwarded verbatim (stall_shard)
        self.flight_dir = flight_dir
        self._epochs: Dict[int, int] = {}
        self._sup_config = supervisor_config
        self.supervisor: Optional[ActorSupervisor] = None
        os.makedirs(self.dirpath, exist_ok=True)
        self.shard_set = RemoteShardSet(
            num_shards, self._address_of, wire_config=self.wire_config,
            auth_token=auth_token, max_frame_bytes=max_frame_bytes,
            read_deadline_s=heartbeat_s)

    # ------------------------------------------------------------ addresses
    def _addr_path(self, proc_index: int) -> str:
        return os.path.join(self.dirpath, f"shard_proc{proc_index}.addr")

    def _address_of(self, shard_id: int) -> Optional[str]:
        """A shard's current address from its process's address file
        (rewritten atomically by every incarnation)."""
        per = self.num_shards // self.num_procs
        try:
            with open(self._addr_path(shard_id // per)) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) == 2 and parts[0] == str(shard_id):
                        return parts[1]
        except OSError:
            return None
        return None

    # ------------------------------------------------------------ lifecycle
    def _argv(self, proc_index: int) -> List[str]:
        # The epoch is the slot's incarnation count: argv_fn runs once per
        # spawn.
        self._epochs[proc_index] = self._epochs.get(proc_index, 0) + 1
        per = self.num_shards // self.num_procs
        ids = ",".join(str(i) for i in range(proc_index * per, (proc_index + 1) * per))
        argv = [
            sys.executable, "-m", "r2d2dpg_torch.fleet.shard",
            "--shard-ids", ids,
            "--capacity", str(self.capacity_per_shard),
            "--alpha", str(self.alpha),
            "--prioritized", "1" if self.prioritized else "0",
            "--epoch", str(self._epochs[proc_index]),
            "--seed", str(self.seed),
            "--address-file", self._addr_path(proc_index),
            "--wire", self.wire_config.encoding,
            "--compress", self.wire_config.compress,
            "--max-frame-bytes", str(self.max_frame_bytes),
            "--read-deadline", str(self.heartbeat_s),
            "--num-shard-procs", str(self.num_procs),
            "--proc-index", str(proc_index),
        ]
        if self.chaos_spec:
            argv += ["--chaos-spec", self.chaos_spec]
        if self.flight_dir:
            argv += ["--flight-path",
                     os.path.join(self.flight_dir, f"flight_shard{proc_index}.jsonl")]
        return argv

    def start(self) -> "ShardProcTier":
        env = None
        if self.auth_token:
            # Through the environment, never argv.
            env = dict(os.environ)
            env["R2D2DPG_FLEET_TOKEN"] = self.auth_token
        log_fn = None
        if self.flight_dir:
            log_fn = lambda i: os.path.join(self.flight_dir, f"shard{i}.log")  # noqa: E731
        # Events carry the PROCESS index as "shard_proc", never "shard",
        # the shard-id unit of shard_dead/shard_rejoin.
        self.supervisor = ActorSupervisor(
            self._argv, self.num_procs, role="shard", id_field="shard_proc",
            env=env, log_path_fn=log_fn,
            config=self._sup_config or SupervisorConfig())
        self.supervisor.start()
        return self

    def stop(self) -> None:
        if self.supervisor is not None:
            self.supervisor.stop()
        self.shard_set.close()

    def kill_proc(self, proc_index: int) -> bool:
        """Hard-kill one shard process (the supervisor restarts it); True
        when a kill was delivered."""
        if self.supervisor is None:
            return False
        return self.supervisor.kill_actor(proc_index)

    def respawn_proc(self, proc_index: int) -> bool:
        """Explicitly respawn one shard process, a given-up slot included;
        False while the slot is alive or its backoff owns the respawn."""
        if self.supervisor is None:
            return False
        return self.supervisor.spawn_slot(proc_index, origin="respawn")

    @property
    def restarts_total(self) -> int:
        return 0 if self.supervisor is None else self.supervisor.restarts_total


# --------------------------------------------------------------------- CLI
def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m r2d2dpg_torch.fleet.shard",
                                description=__doc__)
    p.add_argument("--shard-ids", required=True,
                   help="comma-separated shard ids this process hosts (one "
                   "listening socket per shard)")
    p.add_argument("--capacity", type=int, required=True, help="ring capacity per shard")
    p.add_argument("--alpha", type=float, default=0.6)
    p.add_argument("--prioritized", type=int, default=1, choices=[0, 1])
    p.add_argument("--epoch", type=int, default=1,
                   help="this incarnation's epoch fence (the spawner bumps it per "
                   "restart; stamped into every BATCH, checked on every PRIO)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bind", default="127.0.0.1:0",
                   help="listen address per shard ('host:0' = one ephemeral port "
                   "per shard, published via --address-file)")
    p.add_argument("--address-file", default=None,
                   help="publish '<shard_id> <host:port>' lines here (atomic "
                   "rewrite) once every listener is bound")
    p.add_argument("--wire", default="f32", choices=list(wire.ENCODINGS))
    p.add_argument("--compress", default="none", choices=list(wire.COMPRESSIONS))
    p.add_argument("--max-frame-bytes", type=int, default=MAX_FRAME_BYTES)
    p.add_argument("--read-deadline", type=float, default=READ_DEADLINE_S)
    p.add_argument("--fleet-token", default=None,
                   help="shared HELLO secret; defaults to $R2D2DPG_FLEET_TOKEN "
                   "(the spawner passes it via the environment, never argv)")
    p.add_argument("--chaos-spec", default=None,
                   help="seeded chaos schedule; this process fires the "
                   "stall_shard faults that target its --proc-index")
    p.add_argument("--num-shard-procs", type=int, default=1)
    p.add_argument("--proc-index", type=int, default=0)
    p.add_argument("--flight-path", default=None,
                   help="dump this process's flight ring here on exit (its trace "
                   "spans beside it as raw span lines, trace_shard<i>.jsonl)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    shard_ids = [int(s) for s in args.shard_ids.split(",") if s.strip()]
    if not shard_ids:
        raise SystemExit("shard proc: --shard-ids is empty")
    set_flight_identity(shard_proc=args.proc_index)
    if args.flight_path:
        flight_path = args.flight_path
        if os.path.exists(flight_path):
            # A predecessor incarnation's dump is evidence: dump beside it.
            root, ext = os.path.splitext(flight_path)
            flight_path = f"{root}.pid{os.getpid()}{ext}"
        # Raw span lines, which ``obs.flight merge --trace-out`` folds into
        # the run's one Perfetto timeline; never over a predecessor's dump.
        trace_path = os.path.join(os.path.dirname(os.path.abspath(flight_path)),
                                  f"trace_shard{args.proc_index}.jsonl")
        if os.path.exists(trace_path):
            troot, text = os.path.splitext(trace_path)
            trace_path = f"{troot}.pid{os.getpid()}{text}"
        get_flight_recorder().install(
            flight_path, trace_path=trace_path, trace_format="jsonl")
        # The supervisor's teardown is a SIGTERM, whose default skips atexit.
        signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    try:
        wire_config = wire.WireConfig(encoding=args.wire,
                                      compress=args.compress).validate()
    except ValueError as e:
        raise SystemExit(f"shard proc {args.proc_index}: --compress: {e}")
    auth_token = args.fleet_token
    if auth_token is None:
        auth_token = os.environ.get("R2D2DPG_FLEET_TOKEN") or None
    chaos = None
    if args.chaos_spec:
        try:
            chaos = fleet_chaos.ShardChaos(
                fleet_chaos.parse_chaos_spec(args.chaos_spec),
                seed=args.seed,
                num_shard_procs=args.num_shard_procs,
                proc_index=args.proc_index,
            )
        except ValueError as e:
            raise SystemExit(f"shard proc {args.proc_index}: {e}")
    servers = [
        ShardServer(
            ReplayShard(args.capacity, alpha=args.alpha,
                        prioritized=bool(args.prioritized), shard_id=sid),
            address=args.bind, epoch=args.epoch, seed=args.seed,
            wire_config=wire_config, max_frame_bytes=args.max_frame_bytes,
            read_deadline_s=args.read_deadline, auth_token=auth_token,
            chaos=chaos,
        ).start()
        for sid in shard_ids
    ]
    if args.address_file:
        # Atomic publish once every listener is bound.
        tmp = f"{args.address_file}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            for srv in servers:
                f.write(f"{srv.shard.shard_id} {srv.address}\n")
        os.replace(tmp, args.address_file)
    flight_event("shard_start", proc=args.proc_index, epoch=args.epoch, shards=shard_ids)
    print(f"shard proc {args.proc_index} epoch {args.epoch}: serving "
          + ", ".join(f"shard {s.shard.shard_id} on {s.address}" for s in servers),
          flush=True)
    try:
        while True:
            time.sleep(3600)
    finally:
        for srv in servers:
            srv.stop()


if __name__ == "__main__":
    main()
