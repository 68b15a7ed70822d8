"""Learner-side experience ingest: N actor connections -> one staging queue.

Port of ``r2d2dpg_tpu/fleet/ingest.py``.  Out-of-process actors stream
``replay.StagedSequences`` batches over the fleet wire
(``fleet/transport.py``, ``fleet/wire.py``); this server puts them on a
bounded staging queue, and ``FleetLearner`` drains it into the replay
arena through the pipelined executor's drain body
(``training/pipeline.py::drain_staged``).  Given ``shards`` (the sampler
path, ``fleet/sampler.py``), each handler instead writes an actor's
batches straight into that actor's replay shard: in-learner numpy rings
or, through ``fleet/shard.py``'s ``RemoteShardSet``, standalone shard
processes.  Those acks are always ``OK``: a full shard ring evicts.

Per-connection protocol (one handler thread per actor; that thread is the
connection's only writer, so acks and param pushes never interleave)::

    actor                          ingest handler
    -----                          --------------
    HELLO {actor_id, wire...} ->        (wire mismatch: ACK refused_wire
                                         + close)
                              <-   [PARAMS {version, params}]   (if any)
                              <-   ACK {code: ok, param_version}
    SEQS {staged, stats}      ->   staging_queue.put (bounded wait)
                              <-   [PARAMS]     (actor's version is stale)
                              <-   ACK {code: ok | shed_ingest_queue_full}
    ...
    BYE                       ->   (or either side just closes)

Backpressure and shedding: the actor blocks on the ACK, so it has at most
one unacknowledged batch in flight; the handler waits ``shed_after_s`` for
queue room and then sheds loudly (``SHED_INGEST`` ack, a ``shed`` flight
event, the per-actor shed counter).  Waiting handlers get room in arrival
order (a port-only rule: JAX's sliced ``queue.put`` lets a late handler
take room freed for an earlier one), and a steady-state wait of 0.5 s or
more is a ``put_wait`` flight event.  The scalar stats of a shed batch are
banked and folded back by the learner: experience may be dropped, the
accounting may not.

What the card needs (handler threads make no CUDA call at all):

- **Decoded frames stay numpy.**  A SEQS frame decodes into read-only
  views over the received bytes.  ``put_staged`` stacks a drain's batches
  on the host straight into one fresh byte buffer and makes ONE
  host-to-device copy of it, on the learner's thread and current stream;
  the leaves are typed views of that device buffer.  Nothing reads the
  frames' memory after the copy.
- **Params are published by copy.**  ``snapshot_params`` copies the four
  param trees to the host in one synchronous transfer
  (``transport.to_host``), which waits for the step that produced them;
  handler threads pack that numpy snapshot once per version.
- **No module sharing.**  Neither handlers nor the supervisor call an
  agent module (``functional_call`` swaps a module's parameters for the
  length of a call); only the learner's thread runs the nets.

Direct data plane (``--shard-direct``): given ``shard_assignment_fn``,
every ack carries the actor's shard advert ``{shard, address, epoch}``;
the actor then ships SEQS to its shard and sends only a K_STATS frame of
accounting here, banked through ``shards.bank_stats`` and acked like SEQS.

Fleet telemetry (``--obs-fleet``): an actor pushes its registry snapshot
as a fire-and-forget TELEM frame; the handler folds it into the process
``RemoteMirror`` under ``actor=``/``host=`` labels (the actor id is the
connection's HELLO'd one, never the payload's) and keeps a per-actor
staleness gauge, armed at HELLO.  A malformed push costs one
``telem_malformed`` flight event, never the connection.

Unlike the JAX learner, nothing compiles the coalesce
widths in the background (eager torch has no compile to hide: the pull
limit is ``drain_coalesce`` from the first drain).
"""

from __future__ import annotations

import collections
import dataclasses
import hmac
import json
import os
import queue
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from r2d2dpg_torch.fleet import transport, wire
from r2d2dpg_torch.fleet.transport import (
    HEADER_BYTES,
    K_ACK,
    K_BYE,
    K_HELLO,
    K_PARAMS,
    K_SEQS,
    K_STATS,
    K_TELEM,
    FrameError,
    PeerDeadError,
    pack_obj,
    recv_frame,
    unpack_obj,
    recv_frame_heartbeat,
    flatten_tree,
    send_frame,
    to_host,
)
from r2d2dpg_torch.obs import (
    flight_event,
    get_device_monitor,
    get_registry,
    get_remote_mirror,
)
from r2d2dpg_torch.obs.device import count_flops
from r2d2dpg_torch.obs import trace as obs_trace
from r2d2dpg_torch.obs.quality import (
    get_quality_plane,
    policy_lags,
    quality_stats_columns,
)
from r2d2dpg_torch.parallel.control import ABSORB, LEARN, STOP, control_plane
from r2d2dpg_torch.replay.arena import StagedSequences, staged_nbytes
from r2d2dpg_torch.training.pipeline import (
    coalesce_from_queue,
    drain_staged,
    merge_state,
    split_state,
)
from r2d2dpg_torch.training.assembler import emit
from r2d2dpg_torch.training.trainer import Trainer, TrainerState
from r2d2dpg_torch.tree import tree_map
from r2d2dpg_torch.utils.codes import OK, REFUSED_AUTH, REFUSED_WIRE, SHED_INGEST
from r2d2dpg_torch.utils.metrics import PercentileWindow
from r2d2dpg_torch.utils.profiling import annotate


# Sheds are suppressed (handlers wait this long instead) until the first
# drain-learn has run: startup (actor spawn, replay fill) must not cost
# every actor one shed.
STARTUP_SHED_GRACE_S = 120.0
# A drain-learn iteration whose learner-side time (dequeue to the end of
# the iteration) reaches this many seconds lands in the flight recorder as
# a ``drain_stall`` event with where its time went (``_StallClock``).
STALL_EVENT_S = 0.5


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Static fleet knobs (the trainer's own config governs the rest)."""

    num_actors: int
    address: str = "127.0.0.1:0"  # "host:port" (0 = ephemeral) | "unix:/path"
    queue_depth: int = 4  # staging-queue capacity, in staged batches
    publish_every: int = 1  # drain phases between param publications
    shed_after_s: float = 1.0  # handler waits this long before shedding
    idle_timeout_s: float = 300.0  # no batch for this long = starved, abort
    # One encoding/compression per fleet, negotiated at HELLO.
    wire: wire.WireConfig = wire.WireConfig()
    # Max queued staged batches stacked into ONE drain (1 = one drain per
    # batch); widths are powers of two.
    drain_coalesce: int = 1
    # Liveness: per-connection read deadline; the window between HELLO and
    # the first SEQS frame uses the larger of this and
    # transport.WARMUP_DEADLINE_S.
    heartbeat_s: float = transport.READ_DEADLINE_S
    # Shared-secret HELLO authentication (hmac.compare_digest); None = off.
    auth_token: Optional[str] = None
    # The sampler's pull loop (--replay-shards): concurrent SAMPLE_REQ
    # pullers over the shards (0 = min(shards, 8); 1 = serial), and one
    # phase of batch prefetch on the standalone tier (0 = off).
    shard_pullers: int = 0
    shard_prefetch: int = 0
    # Split planes: actors dial their shard directly for SEQS and keep this
    # connection for HELLO, params and accounting.  Needs the standalone
    # shard tier; any data-leg failure falls back loudly to forwarding.
    shard_direct: bool = False


class IngestServer:
    """Accepts actor connections and feeds the learner's staging queue."""

    def __init__(
        self,
        staging_queue: "queue.Queue",
        *,
        address: str = "127.0.0.1:0",
        shed_after_s: float = 1.0,
        startup_shed_grace_s: float = STARTUP_SHED_GRACE_S,
        wire_config: Optional[wire.WireConfig] = None,
        read_deadline_s: float = transport.READ_DEADLINE_S,
        auth_token: Optional[str] = None,
        shards=None,
        expected_actors: Optional[int] = None,
        shard_assignment_fn: Optional[Callable[[str], Any]] = None,
    ):
        self.queue = staging_queue
        # The sampler path: ``route(actor)`` and ``add(shard_id, msg)``
        # (``ShardSet`` or ``RemoteShardSet``) take every SEQS batch in
        # place of the staging queue.
        self.shards = shards
        # The direct data plane: ``actor -> {"shard", "address", "epoch"}``
        # or None (keep forwarding through this server).
        self.shard_assignment_fn = shard_assignment_fn
        self._request_address = address
        self.shed_after_s = shed_after_s
        self.startup_shed_grace_s = startup_shed_grace_s
        self.wire_config = (wire_config or wire.WireConfig()).validate()
        self.read_deadline_s = read_deadline_s
        self.warmup_deadline_s = max(transport.WARMUP_DEADLINE_S, read_deadline_s)
        self.auth_token = auth_token
        self.stop_join_s = 5.0  # handler join bound before leak reporting
        # Param snapshots are packed once per version and broadcast to every
        # handler, so every frame inlines its schema (a restarted actor must
        # decode it standalone).
        self._params_packer = wire.TreePacker(
            self.wire_config,
            always_inline=True,
        )
        # Until the first drain-learn has run (mark_steady), handlers wait
        # out the startup grace instead of shedding; the grace also expires
        # startup_shed_grace_s after the first queue hand-off.
        self._steady = threading.Event()
        self._first_put_at: Optional[float] = None
        # Handlers take queue room in arrival order (``_put_or_shed``): one
        # ticket each, and only the oldest ticket waits on the queue.
        self._handoff = threading.Condition()
        self._tickets: "collections.deque[int]" = collections.deque()
        self._next_ticket = 0
        self.address: Optional[str] = None  # resolved at start()
        # What actors dial: ``address``, or loopback for a wildcard bind.
        self.connect_address: Optional[str] = None
        self._unix_path: Optional[str] = None
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._handlers: List[threading.Thread] = []
        self._conns: Dict[int, socket.socket] = {}  # ident -> live socket
        self._conn_actors: Dict[int, str] = {}  # ident -> actor id (HELLO'd)
        self._conn_seq = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        # Latest published params: host trees swapped in by the learner,
        # packed ONCE per version on the first handler push.
        self._params_obj: Optional[Any] = None
        self._params_frame: Optional[bytes] = None
        self._param_version = 0
        self.shed_total = 0
        self.seqs_total = 0
        # Wire accounting (every SEQS frame, shed or not; under _lock).
        self.seqs_received_total = 0
        self.seqs_bytes_total = 0
        self.seqs_raw_bytes_total = 0
        # Monotonic time of each actor id's first SEQS frame.
        self.first_seqs_at: Dict[str, float] = {}
        self._shed_stats = {
            "env_steps_delta": 0.0, "ep_return_sum": 0.0, "ep_count": 0.0,
        }
        reg = get_registry()
        self._obs_frames = reg.counter(
            "r2d2dpg_fleet_frames_total",
            "experience frames received from actors",
            labelnames=("actor",),
        )
        self._obs_seqs = reg.counter(
            "r2d2dpg_fleet_sequences_total",
            "sequences received from actors (pre-shed)",
            labelnames=("actor",),
        )
        self._obs_shed = reg.counter(
            "r2d2dpg_fleet_shed_total",
            "staged batches shed on a full staging queue",
            labelnames=("actor",),
        )
        self._obs_staleness = reg.gauge(
            "r2d2dpg_fleet_param_staleness_versions",
            "published param version minus the actor's last-applied version",
            labelnames=("actor",),
        )
        self._obs_connected = reg.gauge(
            "r2d2dpg_fleet_actors_connected", "live actor connections"
        )
        self._obs_connected.set_fn(lambda: float(len(self._conns)))
        if expected_actors:
            # The spawn target on the scrape itself: the /health
            # actors_down rule compares the supervisor's
            # r2d2dpg_fleet_actors_alive against it, and an autoscale
            # resize moves it (set_expected_actors).
            self._obs_expected = reg.gauge(
                "r2d2dpg_fleet_actors_expected",
                "the fleet's actor spawn target (--actors N)",
            )
            self._obs_expected.set(float(expected_actors))
        else:
            self._obs_expected = None
        self._obs_peer_dead = reg.counter(
            "r2d2dpg_fleet_peer_dead_total",
            "connections reaped after a silent heartbeat deadline (the "
            "peer answered neither frames nor the PING probe)",
            labelnames=("actor",),
        )
        self._obs_bytes_in = reg.counter(
            "r2d2dpg_fleet_bytes_in_total",
            "bytes received off the fleet wire (frames + headers)",
            labelnames=("actor",),
        )
        self._obs_bytes_out = reg.counter(
            "r2d2dpg_fleet_bytes_out_total",
            "bytes sent on the fleet wire (acks + param pushes)",
            labelnames=("actor",),
        )
        self._obs_ratio = reg.gauge(
            "r2d2dpg_fleet_compress_ratio",
            "declared decompressed size over received payload size of the "
            "last SEQS frame (1.0 = uncompressed wire)",
        )
        # The fleet telemetry plane: TELEM snapshots fold into the process
        # RemoteMirror (the exporter merges it into one /metrics page), and
        # each actor gets a live staleness gauge.
        self._mirror = get_remote_mirror()
        self._telem_last: Dict[str, float] = {}
        self._obs_telem = reg.counter(
            "r2d2dpg_fleet_telem_frames_total",
            "TELEM registry snapshots received from actors",
            labelnames=("actor",),
        )
        self._obs_telem_staleness = reg.gauge(
            "r2d2dpg_fleet_telem_staleness_seconds",
            "seconds since this actor's last TELEM snapshot (a wedged or "
            "dead actor goes visibly stale)",
            labelnames=("actor",),
        )

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "IngestServer":
        if self._listener is not None:
            raise RuntimeError("ingest server already started")
        family, target = transport.parse_address(self._request_address)
        sock = socket.socket(family, socket.SOCK_STREAM)
        if family == socket.AF_INET:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        elif os.path.exists(target):
            # A stale socket file would fail the bind; unlink it only if
            # nothing answers (never steal a live run's address).
            probe = socket.socket(family, socket.SOCK_STREAM)
            probe.settimeout(0.5)
            try:
                probe.connect(target)
            except OSError:
                os.unlink(target)
            else:
                raise RuntimeError(
                    f"ingest address unix:{target} already has a live "
                    f"server; is another fleet run using it?"
                )
            finally:
                probe.close()
        sock.bind(target)
        sock.listen(64)
        if family == socket.AF_INET:
            host, port = sock.getsockname()[:2]
            self.address = f"{host}:{port}"
            dial_host = "127.0.0.1" if host in ("0.0.0.0", "::", "") else host
            self.connect_address = f"{dial_host}:{port}"
        else:
            self.address = f"unix:{target}"
            self.connect_address = self.address
            self._unix_path = target
        self._listener = sock
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="fleet-ingest-accept", daemon=True
        )
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._listener is not None:
            # A bare close does not wake a thread blocked in accept(2): TCP
            # listeners are shut down; an AF_UNIX one is poked awake.
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            if self._unix_path is not None:
                try:
                    poke = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                    poke.settimeout(0.5)
                    poke.connect(self._unix_path)
                    poke.close()
                except OSError:
                    pass
            try:
                self._listener.close()
            except OSError:
                pass
            if self._unix_path is not None:
                try:
                    os.unlink(self._unix_path)
                except OSError:
                    pass
        with self._lock:
            conns = list(self._conns.values())
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
        for t in list(self._handlers):
            t.join(timeout=self.stop_join_s)
            if t.is_alive():
                print(
                    f"fleet ingest: handler thread {t.name} still alive "
                    f"{self.stop_join_s:.0f}s after stop; leaked (wedged "
                    f"handler; see flight.jsonl)",
                    flush=True,
                )
                flight_event("ingest_handler_leaked", thread=t.name)

    def mark_steady(self) -> None:
        """Startup is over (the first drain-learn has run): queue-full
        waits shed after ``shed_after_s`` from here on."""
        self._steady.set()

    @property
    def is_steady(self) -> bool:
        """Whether the warm-up grace has ended (mark_steady ran): the
        autoscaler defers its load rules until then."""
        return self._steady.is_set()

    def set_expected_actors(self, n: int) -> None:
        """Move ``r2d2dpg_fleet_actors_expected`` to a landed autoscale
        target, so ``actors_down`` judges against the current population.
        A no-op for a server built without an expected count."""
        if self._obs_expected is not None:
            self._obs_expected.set(float(n))

    # ---------------------------------------------------------------- params
    def publish_params(self, version: int, params: Any) -> None:
        """Swap in a new versioned param snapshot (numpy trees: the caller
        copies from the device, ``snapshot_params``).  Handlers push it to
        each actor ahead of that actor's next ack."""
        with self._lock:
            self._param_version = int(version)
            self._params_obj = params
            self._params_frame = None

    def _fold_telem(self, actor: str, telem: Any) -> None:
        """Fold one actor's TELEM snapshot into the remote mirror under
        ``actor=<id>`` (+ ``host=``).  Keyed by actor id, so a reconnecting
        actor updates its source.  Raises on a malformed payload."""
        if not isinstance(telem, dict):
            raise ValueError("TELEM payload is not a dict")
        snapshot = telem.get("snapshot")
        if not isinstance(snapshot, dict):
            raise ValueError("TELEM snapshot is not a dict")
        labels = {"actor": actor}
        host = telem.get("host")
        if host:
            labels["host"] = str(host)
        self._mirror.update(f"actor:{actor}", labels, snapshot)
        with self._lock:
            self._telem_last[actor] = time.monotonic()
        self._arm_telem_staleness(actor)
        self._obs_telem.labels(actor=actor).inc()

    def _arm_telem_staleness(self, actor: str) -> None:
        """Install the actor's staleness gauge (idempotent).  Armed at
        HELLO, so an actor that never delivers a well-formed TELEM shows a
        growing staleness instead of no series."""
        with self._lock:
            self._telem_last.setdefault(actor, time.monotonic())
        self._obs_telem_staleness.labels(actor=actor).set_fn(
            lambda a=actor: time.monotonic() - self._telem_last.get(a, 0.0)
        )

    def _params_snapshot(self):
        """Lazy pack on the FIRST push (a handler thread), once per
        version, outside the server lock; the payload is one bytes object
        broadcast to every handler."""
        with self._lock:
            version = self._param_version
            frame, obj = self._params_frame, self._params_obj
        if frame is None and obj is not None:
            frame = b"".join(
                self._params_packer.pack({"version": version, "params": obj})
            )
            with self._lock:
                if self._param_version == version and self._params_frame is None:
                    self._params_frame = frame
        return version, frame

    def pop_shed_stats(self) -> Dict[str, float]:
        """Drain the scalar stats banked off shed messages."""
        with self._lock:
            out = dict(self._shed_stats)
            for k in self._shed_stats:
                self._shed_stats[k] = 0.0
        return out

    def drop_connection(self, actor: Optional[str] = None) -> Optional[str]:
        """Abruptly close one live actor connection (a mid-run network
        reset).  ``actor`` picks by HELLO'd id; ``None`` (or an id with no
        live connection) drops the oldest live connection.  Returns the
        dropped actor id, or None when no connection is live."""
        with self._lock:
            ident = None
            if actor is not None:
                for i, a in self._conn_actors.items():
                    if a == str(actor) and i in self._conns:
                        ident = i
                        break
            if ident is None and self._conns:
                ident = next(iter(self._conns))
            if ident is None:
                return None
            conn = self._conns[ident]
            dropped = self._conn_actors.get(ident, "?")
        try:
            # SHUT_RDWR first: close() alone does not wake a blocked recv.
            conn.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            conn.close()
        except OSError:
            pass
        return dropped

    # ------------------------------------------------------------ connection
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            if self._stop.is_set():
                try:
                    conn.close()
                except OSError:
                    pass
                return
            transport.configure_socket(conn)
            # Warm-up deadline until the first SEQS frame (a fresh actor's
            # start-up is legitimate silence).
            conn.settimeout(self.warmup_deadline_s)
            with self._lock:
                self._conn_seq += 1
                ident = self._conn_seq
                self._conns[ident] = conn
            self._handlers = [t for t in self._handlers if t.is_alive()]
            t = threading.Thread(
                target=self._handle,
                args=(ident, conn),
                name=f"fleet-ingest-conn{ident}",
                daemon=True,
            )
            self._handlers.append(t)
            t.start()

    def _push_params_if_stale(
        self, conn: socket.socket, sent_version: int, bytes_out
    ) -> int:
        version, frame = self._params_snapshot()
        if frame is not None and version > sent_version:
            bytes_out.inc(
                send_frame(conn, K_PARAMS, frame)
            )
            return version
        return sent_version

    def _assignment(self, actor: str, wait_s: float = 0.0):
        """The actor's shard advert, or None.  An assignment function that
        raises never costs the control connection.  ``wait_s`` bounds the
        HELLO-time poll for the tier's address file, so the first staged
        batch already rides the data plane; steady acks pass 0."""
        if self.shard_assignment_fn is None:
            return None
        deadline = time.monotonic() + wait_s
        while True:
            try:
                assignment = self.shard_assignment_fn(actor)
            except Exception as e:  # noqa: BLE001 - advisory, never fatal
                flight_event(
                    "assignment_error",
                    actor=actor,
                    error=f"{type(e).__name__}: {e}",
                )
                return None
            if assignment is not None or time.monotonic() >= deadline:
                return assignment
            if self._stop.is_set():
                return None
            time.sleep(0.1)

    def _send_ack(self, conn, bytes_out, actor: str, ack: dict,
                  wait_s: float = 0.0) -> None:
        """One ACK on the control connection, with the shard advert when
        there is one."""
        assignment = self._assignment(actor, wait_s)
        if assignment is not None:
            ack["shard_assignment"] = assignment
        bytes_out.inc(
            send_frame(conn, K_ACK, pack_obj(ack))  # wire-lint: control
        )

    def _put_or_shed(self, msg) -> bool:
        """Bounded-wait enqueue: True = queued, False = shed.

        The bound is ``shed_after_s`` once the learner marks steady (or the
        grace has elapsed since the first hand-off), the startup grace
        before that.  The wait runs in short slices, so a stopping server
        reclaims its handlers quickly.

        Handlers get queue room in arrival order: each takes a ticket, and
        only the oldest waits on the queue, the others on ``_handoff``.  A
        sliced ``queue.put`` alone is not fair: a waiter whose slice ends
        rejoins the queue's waiters behind the others, and a handler that
        arrives as a slot frees can take it before the woken waiter does,
        so on a full queue one handler could wait several drains while
        another waited one."""
        now = time.monotonic()
        in_grace = not self._steady.is_set() and (
            self._first_put_at is None
            or now - self._first_put_at < self.startup_shed_grace_s
        )
        if in_grace:
            anchor = now if self._first_put_at is None else self._first_put_at
            deadline = max(
                now + self.shed_after_s,
                anchor + self.startup_shed_grace_s,
            )
        else:
            deadline = now + self.shed_after_s
        with self._handoff:
            ticket = self._next_ticket
            self._next_ticket += 1
            self._tickets.append(ticket)
        try:
            while not self._stop.is_set():
                with self._handoff:
                    if self._tickets[0] != ticket:  # an older handler waits first
                        left = deadline - time.monotonic()
                        if left <= 0:
                            self._note_put_wait(msg, now, shed=True)
                            return False
                        self._handoff.wait(min(0.25, left))
                        continue
                try:
                    self.queue.put(
                        msg,
                        timeout=min(0.25, max(deadline - time.monotonic(), 0.0)),
                    )
                    if self._first_put_at is None:
                        self._first_put_at = time.monotonic()
                    self._note_put_wait(msg, now, shed=False)
                    return True
                except queue.Full:
                    if time.monotonic() >= deadline:
                        self._note_put_wait(msg, now, shed=True)
                        return False
            return False  # stopping: drop silently, the run is over
        finally:
            with self._handoff:
                self._tickets.remove(ticket)
                self._handoff.notify_all()

    def _note_put_wait(self, msg, t0: float, shed: bool) -> None:
        """A steady-state hand-off that waited ``STALL_EVENT_S`` or more for
        queue room lands in the flight recorder as ``put_wait`` (the queue
        contention a shed comes from)."""
        waited = time.monotonic() - t0
        if waited >= STALL_EVENT_S and self._steady.is_set():
            flight_event("put_wait", wait_s=waited, shed=shed,
                         actor=msg.get("actor_id") if isinstance(msg, dict) else None,
                         queued=self.queue.qsize())

    def _handle(self, ident: int, conn: socket.socket) -> None:
        actor = "?"
        # Per-connection wire state: the peer's packer lives on its side of
        # this socket, so the schema cache dies with it too.
        unpacker = wire.TreeUnpacker()
        try:
            kind, payload = recv_frame(conn)
            if kind != K_HELLO:
                raise FrameError(f"expected HELLO, got kind {kind}")
            # JSON, never pickle: this parse runs BEFORE the auth check.
            hello = transport.unpack_hello(payload)
            actor = str(hello.get("actor_id", "?"))
            if self.auth_token is not None:
                # Constant-time comparison, before any per-actor state.
                want = transport.hello_auth_proof(self.auth_token)
                got = str(hello.get("auth", ""))
                if not hmac.compare_digest(want, got):
                    flight_event("auth_refused", actor=actor)
                    send_frame(
                        conn,
                        K_ACK,
                        pack_obj(  # wire-lint: control
                            {"code": REFUSED_AUTH, "param_version": 0}
                        ),
                    )
                    return
            with self._lock:
                self._conn_actors[ident] = actor
            bytes_in = self._obs_bytes_in.labels(actor=actor)
            bytes_out = self._obs_bytes_out.labels(actor=actor)
            bytes_in.inc(HEADER_BYTES + len(payload))
            mismatch = wire.check_negotiation(hello, self.wire_config)
            if mismatch is not None:
                # One fleet, one wire format: refuse at the door, loudly.
                flight_event("wire_refused", actor=actor, reason=mismatch)
                bytes_out.inc(
                    send_frame(
                        conn,
                        K_ACK,
                        pack_obj(  # wire-lint: control
                            {
                                "code": REFUSED_WIRE,
                                "param_version": 0,
                                "reason": mismatch,
                                "expect": wire.negotiation_fields(
                                    self.wire_config
                                ),
                            }
                        ),
                    )
                )
                return
            # Staleness counts from this accepted HELLO, not from a first
            # well-formed TELEM (which may never come).
            self._arm_telem_staleness(actor)
            sent_version = self._push_params_if_stale(conn, 0, bytes_out)
            # A fresh tier publishes its address file a beat after the
            # first HELLOs: wait for it, so no warm-up batch is forwarded.
            self._send_ack(
                conn, bytes_out, actor,
                {"code": OK, "param_version": sent_version}, wait_s=10.0,
            )
            streaming = False  # the first SEQS tightens the read deadline
            while not self._stop.is_set():
                kind, payload = recv_frame_heartbeat(
                    conn,
                    bytes_in=bytes_in.inc,
                    bytes_out=bytes_out.inc,
                )
                t_recv = time.time()
                bytes_in.inc(HEADER_BYTES + len(payload))
                if kind == K_BYE:
                    return
                if kind == K_TELEM:
                    # Fire-and-forget: fold or drop.  A malformed snapshot
                    # costs one flight event, never the connection.
                    try:
                        self._fold_telem(
                            actor, unpack_obj(payload)  # wire-lint: control
                        )
                    except Exception as e:  # noqa: BLE001 - quarantine
                        flight_event("telem_malformed", actor=actor,
                                     error=f"{type(e).__name__}: {e}")
                    continue
                if kind == K_STATS:
                    # The batch went straight to the actor's shard; this
                    # frame carries only the accounting deltas, banked
                    # into the sums the forwarded ``add`` banks.
                    if not streaming:
                        conn.settimeout(self.read_deadline_s)
                        streaming = True
                    stats_msg = unpack_obj(payload)  # wire-lint: control
                    if self.shards is not None:
                        self.shards.bank_stats(stats_msg)
                    self._obs_staleness.labels(actor=actor).set(
                        self._param_version
                        - int(stats_msg.get("param_version", 0))
                    )
                    sent_version = self._push_params_if_stale(
                        conn, sent_version, bytes_out
                    )
                    self._send_ack(
                        conn, bytes_out, actor,
                        {"code": OK, "param_version": sent_version},
                    )
                    continue
                if kind != K_SEQS:
                    raise FrameError(f"expected SEQS/BYE, got kind {kind}")
                if not streaming:
                    conn.settimeout(self.read_deadline_s)
                    streaming = True
                    with self._lock:
                        self.first_seqs_at.setdefault(actor, time.monotonic())
                msg = unpacker.unpack(payload)
                if not (isinstance(msg, dict)
                        and isinstance(msg.get("staged"), StagedSequences)):
                    raise FrameError("SEQS payload carries no staged batch")
                t_decode_end = time.time()
                tr = unpacker.last_trace
                if tr is not None and self.shards is not None:
                    # The sampler traces its own pull chain; a SEQS chain
                    # would never complete here, so none is started.
                    tr = None
                if tr is not None:
                    # The sampled batch's actor-side stamps and this
                    # handler's receive/decode times ride the message; the
                    # learner records all 8 hops of the batches it trains.
                    msg["trace"] = {
                        "id": tr.trace_id,
                        "actor": actor,
                        "t_collect_start": tr.t_collect_start,
                        "t_collect_end": tr.t_collect_end,
                        "t_encode_end": tr.t_encode_end,
                        "t_recv": t_recv,
                        "t_enqueue_start": t_decode_end,
                    }
                msg["actor_id"] = actor
                n_seqs = int(np.shape(msg["staged"].seq.reward)[0])
                self._obs_frames.labels(actor=actor).inc()
                self._obs_seqs.labels(actor=actor).inc(n_seqs)
                self._obs_staleness.labels(actor=actor).set(
                    self._param_version - int(msg.get("param_version", 0))
                )
                self._obs_ratio.set(
                    unpacker.last_raw_len / max(unpacker.last_payload_len, 1)
                )
                with self._lock:
                    self.seqs_received_total += n_seqs
                    self.seqs_bytes_total += HEADER_BYTES + len(payload)
                    self.seqs_raw_bytes_total += unpacker.last_raw_len
                if self.shards is not None:
                    # Routed per frame: on the standalone tier the route
                    # follows shard liveness, and the accounting deltas
                    # bank learner-side inside ``add`` either way.
                    self.shards.add(self.shards.route(actor), msg)
                    code = OK
                    with self._lock:
                        self.seqs_total += n_seqs
                elif self._put_or_shed(msg):
                    code = OK
                    with self._lock:
                        self.seqs_total += n_seqs
                else:
                    if self._stop.is_set():
                        return
                    code = SHED_INGEST
                    with self._lock:
                        self.shed_total += 1
                        for k in self._shed_stats:
                            self._shed_stats[k] += float(msg.get(k, 0.0))
                    self._obs_shed.labels(actor=actor).inc()
                    flight_event(
                        "shed", code=code, actor=actor,
                        phase=int(msg.get("phase", -1)),
                    )
                sent_version = self._push_params_if_stale(
                    conn, sent_version, bytes_out
                )
                self._send_ack(
                    conn, bytes_out, actor,
                    {"code": code, "param_version": sent_version},
                )
        except PeerDeadError as e:
            if not self._stop.is_set():
                # The liveness verdict: a peer that answered neither frames
                # nor the PING probe is reaped, loudly attributed.
                flight_event(
                    "peer_dead",
                    actor=actor,
                    deadline_s=self.read_deadline_s,
                    error=str(e),
                )
                self._obs_peer_dead.labels(actor=actor).inc()
        except (FrameError, OSError) as e:
            if not self._stop.is_set():
                # A crashed actor's torn stream: note it and drop the
                # connection; the supervisor owns the restart.
                flight_event(
                    "ingest_conn_error",
                    actor=actor,
                    error=f"{type(e).__name__}: {e}",
                )
        finally:
            with self._lock:
                self._conns.pop(ident, None)
                self._conn_actors.pop(ident, None)
            try:
                conn.close()
            except OSError:
                pass


# ------------------------------------------------------------ host staging
def put_staged(batches: List[StagedSequences], device) -> StagedSequences:
    """Stack decoded (numpy) staged batches along B and place them on
    ``device`` with ONE host-to-device copy.

    Each leaf's rows are written straight from the frames into one fresh
    host byte buffer (the stacking is that write: no intermediate numpy
    concatenation), the buffer crosses to the device in one copy on the
    current stream, and the leaves are typed views of the device buffer.
    On the CPU the buffer itself backs the tensors.  Priorities must be
    resolved on every batch or on none (mixing raises); provenance present
    on only some batches is dropped, as ``replay.stack_staged`` does."""
    return pack_staged(batches, device)[0]


def pack_staged(batches: List[StagedSequences], device,
                template: Any = None) -> Tuple[StagedSequences, torch.Tensor]:
    """``put_staged``, and the one device byte buffer its leaves view (what
    rank 0 broadcasts to the other ranks of a mesh).  Given ``template``
    (``staged_template``: the layout a follower derives), the batch's
    leaves must match it in order, shape and dtype."""
    if not batches:
        raise ValueError("put_staged needs at least one batch")
    resolved = [b.priorities is not None for b in batches]
    if any(resolved) != all(resolved):
        raise ValueError(
            "put_staged: cannot mix resolved and unresolved priorities"
        )
    if not all(b.behavior_version is not None and b.collect_id is not None
               for b in batches):
        batches = [dataclasses.replace(b, behavior_version=None, collect_id=None)
                   for b in batches]
    per_batch: List[List[np.ndarray]] = []
    build = None
    for b in batches:
        leaves, fn = flatten_tree(b, lambda x: isinstance(x, np.ndarray))
        build = build or fn
        if per_batch and len(leaves) != len(per_batch[0]):
            raise ValueError("put_staged: batches of different structure")
        per_batch.append(leaves)
    columns = list(zip(*per_batch))
    specs = [((sum(a.shape[0] for a in col),) + tuple(col[0].shape[1:]), col[0].dtype)
             for col in columns]
    _check_template(specs, template)
    views, dev = _put_columns(columns, specs, device)
    return build(views), dev


def pack_host(tree: Any, device, template: Any = None) -> Tuple[Any, torch.Tensor]:
    """A tree of numpy arrays on ``device`` with ONE host-to-device copy:
    ``put_staged``'s single fresh buffer for one tree (the sampler's
    pulled batch); the leaves are typed views of the device buffer, which
    is returned beside them.  With ``template``, as ``pack_staged``."""
    leaves, build = flatten_tree(tree, lambda x: isinstance(x, np.ndarray))
    specs = _specs(leaves)
    _check_template(specs, template)
    views, dev = _put_columns([[x] for x in leaves], specs, device)
    return build(views), dev


def unpack_buffer(buf: torch.Tensor, template: Any) -> Any:
    """``template`` (a tree of numpy arrays: the layout) rebuilt as typed
    views of ``buf``, a device byte buffer that ``pack_staged`` or
    ``pack_host`` made on rank 0 and a follower received whole."""
    leaves, build = flatten_tree(template, lambda x: isinstance(x, np.ndarray))
    layout, total = _layout(_specs(leaves))
    if total != buf.numel():
        raise ValueError(f"a payload of {buf.numel()} bytes for a layout of {total}")
    return build(_views(buf, layout))


def staged_template(window, width: int, resolved: bool,
                    provenance: bool) -> StagedSequences:
    """The host layout of a staged batch of ``width`` sequences emitted
    from ``window`` (the learner's own window: the same leaves, shapes and
    dtypes as the actors' emits), with the producer's priorities and the
    provenance columns when present."""
    def rows(x):
        return np.empty((width,) + tuple(x.shape[1:]),
                        torch.empty(0, dtype=x.dtype).numpy().dtype)

    col = (lambda dtype: np.empty(width, dtype))
    return StagedSequences(
        seq=tree_map(rows, emit(window)),
        priorities=col(np.float32) if resolved else None,
        behavior_version=col(np.int64) if provenance else None,
        collect_id=col(np.int64) if provenance else None,
    )


def _specs(leaves) -> list:
    return [(tuple(x.shape), x.dtype) for x in leaves]


def _check_template(specs, template) -> None:
    """A leader's batch must have the layout its followers derive."""
    if template is None:
        return
    want = _specs(flatten_tree(template, lambda x: isinstance(x, np.ndarray))[0])
    if specs != want:
        raise ValueError(f"the batch's layout {specs} is not the learner's "
                         f"template {want}")


def _layout(specs) -> Tuple[list, int]:
    """``(offset, nbytes, shape, dtype)`` per ``(shape, dtype)``, 16-byte
    aligned, and the total bytes."""
    layout, total = [], 0
    for shape, dtype in specs:
        nbytes = int(np.prod(shape)) * dtype.itemsize
        layout.append((total, nbytes, shape, dtype))
        total += -(-nbytes // 16) * 16  # 16-byte aligned views
    return layout, total


def _views(dev: torch.Tensor, layout) -> List[torch.Tensor]:
    return [
        dev[off:off + nbytes].view(torch.from_numpy(np.empty(0, dtype)).dtype)
        .view(shape)
        for off, nbytes, shape, dtype in layout
    ]


def _put_columns(columns, specs, device) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Each column's row blocks stacked into one fresh host byte buffer
    (16-byte aligned per column), one copy to ``device``, one typed view
    per column; and the device buffer."""
    layout, total = _layout(specs)
    host = np.empty(total, np.uint8)
    for col, (off, nbytes, shape, dtype) in zip(columns, layout):
        out = host[off:off + nbytes].view(dtype).reshape(shape)
        np.concatenate(col, axis=0, out=out)
    dev = torch.from_numpy(host).to(device)
    return _views(dev, layout), dev


# -------------------------------------------------------- fleet checkpoints
# The learner-recovery contract: a fleet checkpoint is the LEARNER subtree
# (a light checkpoint) plus this sidecar of host-side monotone counters.
# The replay arena is not checkpointed: a resumed run re-absorbs to
# min_replay from fresh actor experience, and every counter continues
# from where the checkpoint left it.
def fleet_counters_path(directory: str, step: int) -> str:
    return os.path.join(
        os.path.abspath(directory), f"fleet_counters_{int(step)}.json"
    )


def save_fleet_counters(directory: str, step: int, counters: Dict) -> str:
    """Atomically write the counter sidecar next to the checkpoint step
    (tmp + rename).  Returns the path."""
    path = fleet_counters_path(directory, step)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({k: float(v) for k, v in counters.items()}, f)
    os.replace(tmp, path)
    return path


def load_fleet_counters(directory: str, step: int) -> Dict[str, float]:
    """The sidecar for ``step``; a missing file gives an empty dict
    (callers warn: counters would restart at zero)."""
    path = fleet_counters_path(directory, step)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return {k: float(v) for k, v in json.load(f).items()}


def prune_fleet_counters(directory: str, keep_steps) -> None:
    """Drop sidecars whose checkpoint step was pruned (``max_to_keep``)."""
    keep = {int(s) for s in keep_steps}
    directory = os.path.abspath(directory)
    try:
        names = os.listdir(directory)
    except OSError:
        return
    for name in names:
        if not (name.startswith("fleet_counters_") and name.endswith(".json")):
            continue
        try:
            step = int(name[len("fleet_counters_"):-len(".json")])
        except ValueError:
            continue
        if step not in keep:
            try:
                os.unlink(os.path.join(directory, name))
            except OSError:
                pass


class _StallClock:
    """Where a long drain-learn iteration's time went, on the learner thread.

    ``begin()`` at the dequeue, ``mark(name)`` after each segment,
    ``end(**fields)`` at the iteration's end: when the iteration took
    ``STALL_EVENT_S`` or more, one ``drain_stall`` flight event carries its
    wall seconds, each segment's ms, the learner thread's CPU ms
    (``time.thread_time``) beside the whole process's (``os.times``), and
    ``stack``: where the thread stood, sampled
    every ``SAMPLE_S`` by a watcher thread once the iteration is
    ``STALL_EVENT_S / 2`` old (innermost frame first, with counts).  A
    thread that waits for the GIL, a lock, the card or a core shows
    little CPU beside the wall.  ``close()``
    records one ``drain_clock`` event: every drain-learn iteration's wall
    and the learner thread's CPU seconds, summed."""

    SAMPLE_S = 0.02

    def __init__(self):
        self._t = self._cpu = self._proc = None
        self._segments: Dict[str, float] = {}
        self._samples: Dict[str, int] = {}
        self._sums = [0, 0.0, 0.0]  # iterations, wall s, thread CPU s
        self._tid = threading.get_ident()
        self._stop = threading.Event()
        self._watcher = threading.Thread(target=self._watch, name="fleet-stall-watch",
                                         daemon=True)
        self._watcher.start()

    def close(self) -> None:
        self._stop.set()
        n, wall, cpu = self._sums
        if n:
            flight_event("drain_clock", iterations=n, wall_s=wall, thread_cpu_s=cpu,
                         cpu_share=cpu / max(wall, 1e-9))

    def _watch(self) -> None:
        import sys

        while not self._stop.wait(self.SAMPLE_S):
            t = self._t
            if t is None or time.monotonic() - t < STALL_EVENT_S / 2:
                continue
            frame = sys._current_frames().get(self._tid)
            if frame is None:
                continue
            where = []
            while frame is not None and len(where) < 3:
                code = frame.f_code
                where.append(f"{os.path.basename(code.co_filename)}:{frame.f_lineno}"
                             f":{code.co_name}")
                frame = frame.f_back
            key = " < ".join(where)
            self._samples[key] = self._samples.get(key, 0) + 1

    def begin(self) -> None:
        self._segments, self._samples = {}, {}
        self._cpu = time.thread_time()
        self._proc = sum(os.times()[:2])
        self._t = self._last = time.monotonic()

    def mark(self, name: str) -> None:
        now = time.monotonic()
        self._segments[name] = self._segments.get(name, 0.0) + (now - self._last) * 1e3
        self._last = now

    def end(self, **fields) -> None:
        if self._t is None:
            return
        wall = time.monotonic() - self._t
        self._t = None
        cpu = time.thread_time() - self._cpu
        self._sums[0] += 1
        self._sums[1] += wall
        self._sums[2] += cpu
        if wall < STALL_EVENT_S:
            return
        rec = {"wall_s": wall, "segments_ms": self._segments,
               "thread_cpu_ms": cpu * 1e3,
               "process_cpu_ms": (sum(os.times()[:2]) - self._proc) * 1e3,
               "threads": threading.active_count(),
               "stack": sorted(self._samples.items(), key=lambda kv: -kv[1])[:6]}
        flight_event("drain_stall", **rec, **fields)


class FleetLearner:
    """The staging queue's single consumer: drain -> arena add -> K updates.

    Owns the ingest server and runs on the calling thread and its current
    stream.  ``--actors 0`` never constructs this class: the phase-locked
    ``Trainer.run`` path is untouched."""

    def __init__(self, trainer: Trainer, config: FleetConfig):
        if getattr(trainer, "axis", None) is not None:
            raise ValueError(
                "FleetLearner needs a host-visible drain boundary; "
                "shard_map trainers fuse whole phases; use the base Trainer"
            )
        if config.num_actors < 1:
            raise ValueError(
                "FleetLearner requires num_actors >= 1 (fleet=off runs "
                "Trainer.run directly; there is nothing to ingest)"
            )
        if config.queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        if config.drain_coalesce < 1:
            raise ValueError("drain_coalesce must be >= 1")
        config.wire.validate()
        self.trainer = trainer
        self.config = config
        self.queue: "queue.Queue" = queue.Queue(maxsize=config.queue_depth)
        self.server = IngestServer(
            self.queue,
            address=config.address,
            shed_after_s=config.shed_after_s,
            wire_config=config.wire,
            read_deadline_s=config.heartbeat_s,
            auth_token=config.auth_token,
            expected_actors=config.num_actors,
        )
        reg = get_registry()
        self._obs_queue_depth = reg.gauge(
            "r2d2dpg_fleet_staging_queue_depth",
            "staged batches awaiting drain",
        )
        self._obs_queue_depth.set_fn(self.queue.qsize)
        # Absorb-phase waits (actor spawn and start-up, replay fill) are
        # expected and kept apart from the learn-phase starvation waits.
        self.learner_wait = reg.histogram(
            "r2d2dpg_fleet_learner_wait_seconds",
            "learner thread blocked on the fleet staging queue AFTER "
            "absorb (starvation)",
        )
        self.absorb_wait = reg.histogram(
            "r2d2dpg_fleet_absorb_wait_seconds",
            "learner thread blocked on the staging queue during the "
            "absorb-to-min_replay phase (cold start and --resume re-entry)",
        )
        self._obs_coalesce = reg.gauge(
            "r2d2dpg_fleet_drain_coalesce_width",
            "staged batches stacked into the most recent drain",
        )
        self._stats: Dict[str, float] = {}
        self._counters: Dict[str, float] = {}

    # ------------------------------------------------------------- lifecycle
    def start(self) -> str:
        """Bind and start the ingest server; returns the dialable address
        the supervisor hands to actor subprocesses."""
        self.server.start()
        return self.server.connect_address

    def close(self) -> None:
        """Stop the ingest server (stop the supervisor first, so an actor
        losing its connection is not read as a crash)."""
        self.server.stop()
        self._obs_queue_depth.set(0.0)

    def stats(self) -> Dict[str, float]:
        """Instrumentation from the most recent ``run``."""
        return dict(self._stats)

    def counters(self) -> Dict[str, float]:
        """The monotone counters at the end of the most recent ``run``: what
        the final checkpoint's sidecar records for a later resume."""
        return dict(self._counters)

    def _save_checkpoint(
        self, ckpt, step: int, state, cstate, lstate, counters: Dict
    ) -> None:
        """One periodic learner checkpoint (a light manager keeps the
        ``train`` subtree) plus the counter sidecar, pruned in lockstep."""
        ckpt.save(step, merge_state(state, cstate, lstate))
        save_fleet_counters(ckpt.directory, step, counters)
        prune_fleet_counters(ckpt.directory, ckpt.all_steps())

    # ------------------------------------------------------------------- run
    def run(
        self,
        num_train_phases: int,
        state: Optional[TrainerState] = None,
        log_every: int = 50,
        log_fn=print,
        metrics_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
        minutes: Optional[float] = None,
        ckpt=None,
        checkpoint_every: int = 0,
        resume_from: Optional[Dict[str, float]] = None,
        health_fn: Optional[Callable[[], None]] = None,
        phase_fn: Optional[Callable[[int], None]] = None,
    ) -> TrainerState:
        """Absorb staged batches until ``min_replay`` sequences are
        resident, then run ``num_train_phases`` drain-learn phases (one
        drain + K updates each).  The server must already be started; the
        caller owns the actors (the supervisor).

        ``ckpt`` (a LIGHT ``CheckpointManager``) + ``checkpoint_every`` arm
        periodic learner checkpoints with the counter sidecar;
        ``resume_from`` (``load_fleet_counters`` of the restored step)
        continues counters, phase numbering and param versions, and
        ``num_train_phases`` stays the TOTAL across incarnations.
        ``health_fn()`` runs whenever the queue wait times out and may
        raise to abort the run (the train CLI checks that the supervisor
        has not given actors up).  ``phase_fn(drained)`` runs after each
        drain-learn phase with the 1-based count (the chaos engine fires
        its learner-side faults there).

        On a mesh trainer this is rank 0's loop (``parallel/control.py``):
        each absorb and drain-learn sends its control record and the packed
        batch to the other ranks, which run ``follow_drain``; the run's end
        sends STOP, an exception ERROR before it propagates."""
        if self.server.address is None:
            raise RuntimeError("call start() before run()")
        t = self.trainer
        control = control_plane(t)
        if control is not None:
            control.open()
        mon = get_device_monitor().install()
        mon.begin_run()
        state = t.init() if state is None else state
        cstate, lstate = split_state(state)
        deadline = (
            time.monotonic() + minutes * 60 if minutes is not None else None
        )
        self.learner_wait.reset()
        self.absorb_wait.reset()
        resume_from = resume_from or {}
        version = int(resume_from.get("param_version", 0)) + 1
        self.server.publish_params(version, snapshot_params(lstate.train))

        min_seqs = t.config.min_replay
        absorbed = 0
        drained = int(resume_from.get("drained", 0))
        drained_at_start = drained
        last_metrics: Dict[str, Any] = {}
        # Host-side episode accounting: actors ship DELTAS as plain floats,
        # so the sums stay monotone across supervised actor restarts.
        ep_ret_sum = float(resume_from.get("ep_return_sum", 0.0))
        ep_count = float(resume_from.get("ep_count", 0.0))
        env_steps_total = float(resume_from.get("env_steps_total", 0.0))
        episodes_total = float(resume_from.get("episodes_total", 0.0))
        last_batch_t = time.monotonic()
        t0 = time.monotonic()
        # Steady-state window for throughput: from the first drain-learn's end.
        train_t0: Optional[float] = None
        seqs_at_train_t0 = 0
        drain_s = PercentileWindow()

        def emit_log(phase: int, scalars: Dict[str, float]) -> None:
            if metrics_fn is not None:
                metrics_fn(phase, scalars)
                return
            log_fn(
                f"fleet phase {phase}/{num_train_phases} "
                + " ".join(f"{k} {v:.3g}" for k, v in scalars.items())
            )

        coalesce_sum = 0
        coalesce_n = 0
        drain_flops: Dict[int, Optional[float]] = {}  # drain width -> FLOPs
        stall = _StallClock()
        try:
            while drained < num_train_phases:
                if deadline is not None and time.monotonic() >= deadline:
                    break
                t_wait = time.monotonic()
                wait_hist = (
                    self.learner_wait if absorbed > min_seqs else self.absorb_wait
                )
                try:
                    first = self.queue.get(timeout=0.5)
                except queue.Empty:
                    wait_hist.add(time.monotonic() - t_wait)
                    if health_fn is not None:
                        health_fn()
                    # Cold start: the FIRST batch pays actor spawn, imports
                    # and window fill, so it gets double the bound.
                    bound = self.config.idle_timeout_s * (
                        2.0 if absorbed == 0 else 1.0
                    )
                    if time.monotonic() - last_batch_t > bound:
                        raise RuntimeError(
                            f"fleet starved: no staged batch in "
                            f"{self.config.idle_timeout_s:.0f}s; are the "
                            f"actors alive? (the supervisor restarts crashed "
                            f"ones; check flight.jsonl)"
                        )
                    continue
                wait_hist.add(time.monotonic() - t_wait)
                last_batch_t = time.monotonic()
                stall.begin()
                t_dequeue = time.time()
                # Coalesced drain: the got batch plus whatever backlog the
                # queue already holds, up to the power-of-two bucket of
                # drain_coalesce; absorb-phase pulls take one batch.
                limit = 1 if absorbed < min_seqs else self.config.drain_coalesce
                msgs = coalesce_from_queue(self.queue, first, limit)
                coalesce_sum += len(msgs)
                coalesce_n += 1
                self._obs_coalesce.set(float(len(msgs)))
                # Fold shed-banked accounting every iteration.
                shed_stats = self.server.pop_shed_stats()
                env_steps_total += shed_stats["env_steps_delta"]
                ep_ret_sum += shed_stats["ep_return_sum"]
                ep_count += shed_stats["ep_count"]
                episodes_total += shed_stats["ep_count"]
                host_staged = [m["staged"] for m in msgs]
                for msg in msgs:
                    ep_ret_sum += float(msg.get("ep_return_sum", 0.0))
                    ep_count += float(msg.get("ep_count", 0.0))
                    episodes_total += float(msg.get("ep_count", 0.0))
                    env_steps_total += float(msg.get("env_steps_delta", 0.0))
                traces = [m["trace"] for m in msgs if m.get("trace")]
                t_drain = time.monotonic()
                with annotate("fleet/drain"):
                    # One host-to-device copy, then the trainer's placement
                    # hook (the dp learner checks the width against its
                    # mesh; identity for one device).
                    n_seqs = sum(int(np.shape(b.seq.reward)[0]) for b in host_staged)
                    template = None
                    if control is not None:
                        template = staged_template(
                            cstate.window, n_seqs,
                            host_staged[0].priorities is not None,
                            all(b.behavior_version is not None
                                and b.collect_id is not None for b in host_staged))
                    staged, buf = pack_staged(host_staged, t.device, template)
                    staged = t._put_staged(staged)
                    learn = absorbed + n_seqs > min_seqs
                    if control is not None:
                        # Every rank hears the drain before anyone acts.
                        after = drained + int(learn)
                        control.send(
                            LEARN if learn else ABSORB, width=n_seqs,
                            resolved=staged.priorities is not None,
                            provenance=staged.behavior_version is not None,
                            drained=after, nbytes=buf.numel(),
                            log=bool(learn and log_every and after % log_every == 0))
                        control.send_payload(buf)
                t_stack_end = time.time()
                stall.mark("pack")
                absorbed += n_seqs
                if not learn:
                    with t.arena.staged_writer():
                        lstate, _ = drain_staged(t, lstate, staged, learn=False)
                    continue
                # Experience-quality fold on the decoded host batch.
                qplane = get_quality_plane()
                if staged.behavior_version is not None:
                    qplane.observe_lags(policy_lags(version, np.concatenate(
                        [b.behavior_version for b in host_staged])))
                for m_q in msgs:
                    qplane.note_trained(
                        m_q["actor_id"],
                        int(np.shape(m_q["staged"].seq.reward)[0]),
                    )
                note_width = getattr(t, "dp_note_learn_width", None)
                if note_width is not None:
                    # The dp learner's per-rank width gauge, set at the
                    # real drain site (host-known B, no fetch).
                    note_width(n_seqs)
                mon.on_phase(drained + 1)
                with t.arena.staged_writer(), annotate("fleet/drain"):
                    if n_seqs not in drain_flops:
                        # The MFU numerator: each drain width runs once
                        # under the FLOP counter (results unchanged).
                        (lstate, last_metrics), drain_flops[n_seqs] = count_flops(
                            drain_staged, t, lstate, staged, prefetch=True)
                    else:
                        lstate, last_metrics = drain_staged(
                            t, lstate, staged, prefetch=True)
                mon.note_learn(drain_flops[n_seqs])
                t_dispatch_end = time.time()
                stall.mark("learn")
                if traces:
                    # One synchronization per SAMPLED drain makes the learn
                    # hop honest; unsampled drains pay nothing.
                    if t.device.type == "cuda":
                        torch.cuda.synchronize(t.device)
                    t_done = time.time()
                    nbytes = staged_nbytes(staged)
                    for tr in traces:
                        tid, act = tr["id"], tr.get("actor")
                        obs_trace.record_hop(
                            "collect", tr["t_collect_start"],
                            tr["t_collect_end"], tid, actor=act)
                        obs_trace.record_hop(
                            "encode", tr["t_collect_end"],
                            tr["t_encode_end"], tid, actor=act)
                        obs_trace.record_hop(
                            "transit", tr["t_encode_end"], tr["t_recv"],
                            tid, actor=act)
                        obs_trace.record_hop(
                            "decode", tr["t_recv"], tr["t_enqueue_start"],
                            tid, actor=act)
                        obs_trace.record_hop(
                            "enqueue", tr["t_enqueue_start"], t_dequeue,
                            tid, actor=act)
                        obs_trace.record_hop(
                            "coalesce", t_dequeue, t_stack_end,
                            tid, actor=act, width=len(msgs))
                        obs_trace.record_hop(
                            "arena_add", t_stack_end, t_dispatch_end,
                            tid, actor=act, bytes=nbytes, seqs=n_seqs)
                        obs_trace.record_hop(
                            "learn", t_dispatch_end, t_done, tid, actor=act)
                drained += 1
                drain_s.add(time.monotonic() - t_drain)
                if train_t0 is None:
                    train_t0 = time.monotonic()
                    seqs_at_train_t0 = absorbed
                    # Startup is over: handlers shed on the real bound now.
                    self.server.mark_steady()
                    mon.mark_steady()
                stall.mark("trace")
                if phase_fn is not None:
                    phase_fn(drained)
                stall.mark("phase_fn")
                if (
                    ckpt is not None
                    and checkpoint_every > 0
                    and drained % checkpoint_every == 0
                ):
                    self._save_checkpoint(
                        ckpt, drained, state, cstate, lstate,
                        {
                            "drained": drained,
                            "env_steps_total": env_steps_total,
                            "ep_return_sum": ep_ret_sum,
                            "ep_count": ep_count,
                            "episodes_total": episodes_total,
                            "param_version": version,
                        },
                    )
                stall.mark("checkpoint")
                if drained % max(self.config.publish_every, 1) == 0:
                    version += 1
                    self.server.publish_params(
                        version, snapshot_params(lstate.train)
                    )
                    if log_every and drained % log_every == 0:
                        flight_event("param_publish", version=version)
                stall.mark("publish")
                if log_every and drained % log_every == 0:
                    # ONE fetch per log cadence: the learn metrics and the
                    # arena's priority sum.
                    names = list(last_metrics)
                    # The dp learner's per-shard gauges ride this
                    # fetch (Trainer._log_extra_refs).
                    psum, extra = _log_refs(t, lstate.arena)
                    fetched = torch.cat(
                        [torch.stack(
                            [psum] + [last_metrics[k].float() for k in names])]
                        + [x.reshape(-1).to(torch.float32) for x in extra]
                    ).tolist()
                    if extra:
                        tail, off = [], 1 + len(names)
                        for x in extra:
                            tail.append(fetched[off:off + x.numel()])
                            off += x.numel()
                        t._log_extra_publish(tail)
                    t.arena.observe_state_scalars(
                        float(t.arena.size(lstate.arena)), fetched[0],
                        float(lstate.arena.total_added),
                    )
                    scalars = {
                        "episode_return_mean": ep_ret_sum / max(ep_count, 1.0),
                        "episodes": ep_count,
                        "env_steps": env_steps_total,
                        "learner_steps": float(lstate.train.step),
                        **dict(zip(names, fetched[1:])),
                    }
                    ep_ret_sum = 0.0
                    ep_count = 0.0
                    t._obs_publish(scalars)
                    emit_log(drained, scalars)
                stall.mark("log")
                stall.end(drained=drained, width=n_seqs, queued=self.queue.qsize())
        except BaseException as e:
            if control is not None and not control.closed:
                control.fail(e)
            raise
        else:
            if control is not None:
                control.stop(drained)
        finally:
            stall.close()
            if t.device.type == "cuda":
                torch.cuda.synchronize(t.device)
            mon.end_run()
            t_end = time.monotonic()
            wall = max(t_end - t0, 1e-9)
            _, lw_total, lw_p50, lw_p99 = self.learner_wait.snapshot()
            _, aw_total, aw_p50, aw_p99 = self.absorb_wait.snapshot()
            _, _, dr_p50, dr_p99 = drain_s.snapshot()
            srv = self.server
            drained_here = drained - drained_at_start
            self._counters = {
                "drained": float(drained),
                "env_steps_total": env_steps_total,
                "ep_return_sum": ep_ret_sum,
                "ep_count": ep_count,
                "episodes_total": episodes_total,
                "param_version": float(version),
            }
            self._stats = {
                "train_phases": float(drained_here),
                "train_phases_total": float(drained),
                "absorbed_seqs": float(absorbed),
                "wall_s": wall,
                "learner_steps_per_sec": (
                    drained_here * t.config.learner_steps / wall
                ),
                "arena_add_seqs_per_sec": absorbed / wall,
                "sheds": float(srv.shed_total),
                "learner_wait_p50_ms": lw_p50 * 1e3,
                "learner_wait_p99_ms": lw_p99 * 1e3,
                "learner_wait_total_s": lw_total,
                "absorb_wait_p50_ms": aw_p50 * 1e3,
                "absorb_wait_p99_ms": aw_p99 * 1e3,
                "absorb_wait_s": aw_total,
                "drain_learn_p50_ms": dr_p50 * 1e3,
                "drain_learn_p99_ms": dr_p99 * 1e3,
                "overlap_fraction": max(0.0, 1.0 - (lw_total + aw_total) / wall),
                "bytes_in_total": float(srv.seqs_bytes_total),
                "bytes_per_seq": (
                    srv.seqs_bytes_total / max(srv.seqs_received_total, 1)
                ),
                "bytes_per_trained_seq": (
                    srv.seqs_bytes_total
                    / max(drained_here * t.config.learner_steps
                          * t.config.batch_size, 1)
                ),
                "wire_ratio": (
                    srv.seqs_raw_bytes_total / max(srv.seqs_bytes_total, 1)
                ),
                "drain_coalesce_width_mean": coalesce_sum / max(coalesce_n, 1),
                **quality_stats_columns(),
                **mon.run_stats(),
            }
            if control is not None:
                self._stats.update(
                    absorb_drains=float(control.payloads - drained_here),
                    control_records=float(control.records),
                    payload_broadcasts=float(control.payloads))
            if train_t0 is not None:
                # Steady-state rates (the whole-run rates above include
                # start-up).
                train_wall = max(t_end - train_t0, 1e-9)
                self._stats["train_wall_s"] = train_wall
                self._stats["train_drain_phases_per_sec"] = (
                    max(drained_here - 1, 0) / train_wall
                )
                self._stats["train_arena_add_seqs_per_sec"] = (
                    absorbed - seqs_at_train_t0
                ) / train_wall
                self._stats["train_learner_steps_per_sec"] = (
                    max(drained_here - 1, 0) * t.config.learner_steps / train_wall
                )
        # phase_idx is a collector-slice field the learner never advances;
        # stamp the drained-phase count so the final checkpoint step
        # reflects the trained run.
        return dataclasses.replace(
            merge_state(state, cstate, lstate),
            phase_idx=cstate.phase_idx + drained,
        )


def _log_refs(t: Trainer, arena) -> Tuple[torch.Tensor, list]:
    """The log cadence's device values, in the order of their collectives
    on a mesh (the leader and its followers call this together): the
    extra refs, then the arena's priority sum."""
    extra = t._log_extra_refs(arena)
    return t.arena.priority_sum(arena), extra


def follow_drain(trainer: Trainer, state: Optional[TrainerState] = None) -> TrainerState:
    """A rank > 0's side of ``FleetLearner.run`` on a mesh trainer: each
    control record, then the packed staged batch (received in place into
    a fresh device buffer: no host copy), then the same absorb or
    drain-learn and the same log-cadence collectives as rank 0, until
    STOP.  An ERROR record raises ``RuntimeError("rank 0 stopped: ...")``.
    Returns the final state, its ``phase_idx`` stamped as rank 0's."""
    t = trainer
    control = control_plane(t)
    control.open()
    state = t.init() if state is None else state
    cstate, lstate = split_state(state)
    drained = 0
    note_width = getattr(t, "dp_note_learn_width", None)
    while True:
        rec = control.recv()
        drained = rec.drained
        if rec.op == STOP:
            break
        buf = control.recv_payload(rec.nbytes)
        staged = t._put_staged(unpack_buffer(buf, staged_template(
            cstate.window, rec.width, rec.resolved, rec.provenance)))
        with t.arena.staged_writer():
            if rec.op == ABSORB:
                lstate, _ = drain_staged(t, lstate, staged, learn=False)
                continue
            if note_width is not None:
                note_width(rec.width)
            lstate, _ = drain_staged(t, lstate, staged, prefetch=True)
        if rec.log:
            _log_refs(t, lstate.arena)
    return dataclasses.replace(merge_state(state, cstate, lstate),
                               phase_idx=cstate.phase_idx + drained)


def snapshot_params(train) -> Any:
    """The published snapshot: everything an actor needs to act AND to rank
    fresh sequences locally (online and target nets of both cores), copied
    to the host in one transfer (``transport.to_host``): a copy, never a
    view of the learner's tensors."""
    return to_host(
        {
            "actor_params": train.actor_params,
            "critic_params": train.critic_params,
            "target_actor_params": train.target_actor_params,
            "target_critic_params": train.target_critic_params,
            "step": int(train.step),
        }
    )
