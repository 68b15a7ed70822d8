"""Chaos drills: seeded faults at the fleet's real boundaries.

Port of ``r2d2dpg_tpu/fleet/chaos.py``, byte for byte where it matters
(the spec grammar and its error texts, the ``fault_target`` hash, the
corrupt frame's bytes).  A fault-tolerance layer is only real if its
recovery paths run: each fault is injected where it happens for real.

========================  ===============================  =====================
fault                     injection boundary               recovery
========================  ===============================  =====================
``kill_actor``            ``ActorSupervisor.kill_actor``   ``actor_crash`` ->
                          (SIGKILL)                        ``actor_restart``
``stall_actor``           actor-side sleep before collect  heartbeat reap
                                                           (``peer_dead``) +
                                                           ``actor_reconnect``
``corrupt_frame``         one payload byte flipped under   ``ingest_conn_error``
                          the pristine CRC                 + ``actor_reconnect``
``kill_ingest_conn``      ``IngestServer.drop_connection`` ``actor_reconnect``
``kill_sampler_conn``     the same close, on the sampler   ``actor_reconnect``,
                          path (the shard feed)            accounting re-banked
``stall_sampler``         the pull loop sleeps             nothing: shards
                                                           ring-evict, 0 sheds
``kill_shard``            ``ShardProcTier.kill_proc``      ``shard_dead`` ->
                          (SIGKILL of a shard process)     restart ->
                                                           ``shard_rejoin``
``stall_shard``           ``ShardChaos.gate`` before every 0 sheds, 0 reaps
                          reply of one shard process
``partition_shard``       ``RemoteShardSet.partition``     reconnect under the
                          (both legs of one shard)         SAME epoch
``partition_data_plane``  the actor shuts its direct data  ``data_plane_fallback``
                          socket down (reference kept)     + re-dial
========================  ===============================  =====================

**Spec grammar** (``--chaos-spec``)::

    spec  := fault ("," fault)*
    fault := kind "@p" phase [":" seconds "s"]
    e.g.    kill_actor@p3,stall_actor@p5:4s,corrupt_frame@p7,kill_ingest_conn@p9

``phase`` is 1-based on the injecting side's clock: learner-side faults
count drain-learn (or pull-learn) phases, actor-side faults the target
actor's emitted batches, ``stall_shard`` the SEQS frames its shard
process absorbed.  Only the stall kinds take (and need) a duration.

Which actor, shard or shard process a fault hits is ``fault_target``:
a sha256 of ``(seed, fault index, fault kind)`` that every process
computes alike, so the learner's engine, each actor and each shard
process (the spec is forwarded verbatim) agree without coordination.

Every injection writes a ``chaos_inject`` flight event, bumps
``r2d2dpg_fleet_chaos_drills_total{fault}`` and dumps the flight ring at
once; the recovery events are the subsystems' own, so ``python -m
r2d2dpg_torch.obs.flight merge <logdir>`` pairs each fault with its
recovery.
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import os
import re
import socket
import threading
import time
import zlib
from typing import Optional, Sequence, Tuple

from r2d2dpg_torch.fleet import transport
from r2d2dpg_torch.obs import flight_event, get_flight_recorder, get_registry

# Faults injected from the learner process (its drain-phase clock) vs from
# inside the target actor process (its emitted-batch clock).
# ``kill_sampler_conn``/``stall_sampler`` drill the in-network-sampling
# peer class (fleet/sampler.py): the first drops the connection
# FEEDING the target actor's replay shard (recovery: actor reconnect with
# at-least-once accounting — a dead shard feed loses only re-collectable
# experience, never step/episode sums); the second stalls the sampler
# learner's own pull loop for its duration (recovery: nothing to recover —
# shards keep absorbing under their own locks and ring-evict instead of
# shedding, which is exactly the property the drill pins).
# ``kill_shard``/``stall_shard``/``partition_shard`` drill the standalone
# shard tier (fleet/shard.py): SIGKILL of a shard process
# (recovery: quota renormalization over survivors + handler re-route,
# then epoch-fenced rejoin after the supervisor's backoff restart), an
# in-shard-process response stall (recovery: nothing — both legs wait it
# out, zero sheds and zero false reaps), and a learner-side drop of BOTH
# legs' connections to one shard (recovery: reconnect; the shard's data
# survives under the SAME epoch — a partition is not a restart).
LEARNER_FAULTS = frozenset(
    {
        "kill_actor",
        "kill_ingest_conn",
        "kill_sampler_conn",
        "stall_sampler",
        "kill_shard",
        "partition_shard",
    }
)
# ``partition_data_plane`` drills the direct actor->shard data leg
# (``--shard-direct``): the actor severs its own data socket at the transport and
# the next direct push fails mid-send — recovery is the LOUD fallback to
# the learner-forwarded path with accounting intact, then a re-dial off
# the next assignment advert.  train.py refuses it without --shard-direct
# (no data plane to partition).
ACTOR_FAULTS = frozenset(
    {"stall_actor", "corrupt_frame", "partition_data_plane"}
)
# Faults fired INSIDE a standalone shard process (fleet/shard.py parses
# the forwarded --chaos-spec; the clock is SEQS frames that process has
# absorbed).  ``kill_shard`` targets a shard PROCESS index (the
# supervisor's SIGKILL unit); ``partition_shard`` targets a SHARD index
# (the connection unit); ``stall_shard`` targets a process index.
SHARD_PROC_FAULTS = frozenset({"stall_shard"})
# The sampler peer class: train.py refuses these without --replay-shards
# (on the central drain a "sampler stall" would stall the DRAIN thread
# and shed — evidence for an invariant that path cannot exhibit).
SAMPLER_FAULTS = frozenset({"kill_sampler_conn", "stall_sampler"})
# The shard-tier class: refused without --shard-procs (the loopback
# shards share the learner's process — there is no shard to kill,
# partition, or stall independently of the learner itself).
SHARD_FAULTS = frozenset({"kill_shard", "stall_shard", "partition_shard"})
# The direct-data-plane class: refused without --shard-direct (with the
# experience riding the learner-forwarded path there is no data leg to
# partition — the drill would silently no-op).
DIRECT_FAULTS = frozenset({"partition_data_plane"})
FAULT_KINDS = tuple(sorted(LEARNER_FAULTS | ACTOR_FAULTS | SHARD_PROC_FAULTS))
# Faults that carry (and require) a :Ds duration suffix.
STALL_FAULTS = frozenset({"stall_actor", "stall_sampler", "stall_shard"})

_FAULT_RE = re.compile(
    r"^(?P<kind>[a-z_]+)@p(?P<phase>\d+)(?::(?P<dur>\d+(?:\.\d+)?)s)?$"
)


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled injection (parsed from the ``--chaos-spec`` grammar)."""

    kind: str
    phase: int  # 1-based, on the injecting side's phase clock
    duration_s: float = 0.0  # stall_actor only
    index: int = 0  # position in the spec: part of the target derivation


def parse_chaos_spec(spec: str) -> Tuple[Fault, ...]:
    """``"kill_actor@p3,stall_actor@p5:4s"`` -> ``(Fault, ...)``.

    Raises ``ValueError`` with the offending token on any malformed entry
    — a chaos schedule that silently dropped a fault would let a broken
    recovery path pass its drill."""
    faults = []
    for i, token in enumerate(t.strip() for t in spec.split(",")):
        if not token:
            raise ValueError(f"empty fault token in chaos spec {spec!r}")
        m = _FAULT_RE.match(token)
        if m is None:
            raise ValueError(
                f"malformed chaos fault {token!r} (grammar: "
                f"kind@pN[:Ds], e.g. stall_actor@p5:4s)"
            )
        kind = m.group("kind")
        if kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown chaos fault {kind!r}; have {sorted(FAULT_KINDS)}"
            )
        phase = int(m.group("phase"))
        if phase < 1:
            raise ValueError(f"chaos fault {token!r}: phase must be >= 1")
        dur = float(m.group("dur") or 0.0)
        if dur and kind not in STALL_FAULTS:
            raise ValueError(
                f"chaos fault {token!r}: only {sorted(STALL_FAULTS)} take "
                f"a duration"
            )
        if kind in STALL_FAULTS and dur <= 0.0:
            raise ValueError(
                f"chaos fault {token!r}: {kind} needs a duration "
                f"(e.g. {kind}@p5:4s)"
            )
        faults.append(Fault(kind=kind, phase=phase, duration_s=dur, index=i))
    return tuple(faults)


def fault_target(fault: Fault, seed: int, num_actors: int) -> int:
    """Which actor id a fault hits: a pure seeded hash every process
    computes identically (no RNG state, no coordination — the learner
    engine and each forwarded-spec actor agree by construction)."""
    digest = hashlib.sha256(
        f"{seed}:{fault.index}:{fault.kind}".encode()
    ).digest()
    return int.from_bytes(digest[:8], "big") % max(num_actors, 1)


def _drill_counter():
    return get_registry().counter(
        "r2d2dpg_fleet_chaos_drills_total",
        "chaos faults injected (one per scheduled drill that fired)",
        labelnames=("fault",),
    )


def record_injection(fault: Fault, actor: int, **extra) -> None:
    """The one way an injection becomes visible: ``chaos_inject`` flight
    event + the per-fault drill counter — shared by both sides so every
    fault is attributable in ``flight.jsonl``/``obs.flight merge``."""
    flight_event(
        "chaos_inject",
        fault=fault.kind,
        phase=fault.phase,
        actor=actor,
        **extra,
    )
    _drill_counter().labels(fault=fault.kind).inc()
    # Flush the ring NOW (atomic; no-op when no dump path is installed):
    # several drills end in a SIGKILL — the injected fault's own, or a
    # teardown kill of a process whose SIGTERM is deferred behind a
    # compile — and a record that only lives in the in-memory ring dies
    # with it.  Durable-at-injection is what makes every fault
    # attributable in flight.jsonl no matter how the drill ends.
    get_flight_recorder().dump()


# ---------------------------------------------------------------- injectors
def send_corrupt_frame(
    sock: socket.socket, kind: int, parts: Sequence, *, flip_at: Optional[int] = None
) -> int:
    """The ``corrupt_frame`` boundary: one payload byte is flipped AFTER
    the header CRC is computed over the pristine bytes — exactly what
    bit-rot or a torn write produces on a real wire — so the receiver's
    CRC check must reject the frame (``FrameCRCError`` kills the
    connection; transport.py's rule).  Returns bytes sent."""
    payload = b"".join(bytes(p) for p in parts)
    if not payload:
        raise ValueError("cannot corrupt an empty payload")
    crc = zlib.crc32(payload)  # pristine: the header promises these bytes
    i = len(payload) // 2 if flip_at is None else flip_at % len(payload)
    corrupted = payload[:i] + bytes([payload[i] ^ 0xFF]) + payload[i + 1:]
    header = transport._HEADER.pack(
        transport.MAGIC, kind, len(payload), crc
    )
    sock.sendall(header)
    sock.sendall(corrupted)
    return transport.HEADER_BYTES + len(payload)


class ChaosEngine:
    """Learner-side scheduler: fires learner-boundary faults on the drain
    clock (``FleetLearner.run``'s ``phase_fn`` hook).

    Actor-boundary faults in the spec are NOT fired here — each actor
    fires its own from the forwarded spec (``ActorChaos``) — but the
    engine knows the whole schedule, so ``unfired()`` at end of run names
    any learner-side drill that never got its phase."""

    def __init__(
        self,
        faults: Sequence[Fault],
        *,
        seed: int,
        num_actors: int,
        supervisor=None,
        server=None,
        shard_tier=None,
    ):
        self.faults = tuple(faults)
        self.seed = seed
        self.num_actors = num_actors
        self.supervisor = supervisor
        self.server = server
        # The standalone shard tier (fleet/shard.py ShardProcTier): the kill_shard boundary is its supervisor's SIGKILL
        # (``kill_proc``), the partition_shard boundary its shard map's
        # both-legs connection drop (``partition``).
        self.shard_tier = shard_tier
        self._fired = set()
        _drill_counter()  # register the family before any drill fires

    def on_phase(self, phase: int) -> None:
        """Fire every due learner-side fault (``phase`` is the drain-learn
        count, 1-based).  ``>=`` rather than ``==``: a resumed run whose
        checkpoint already passed a fault's phase fires it immediately
        rather than silently never.

        A fault is marked fired — and recorded — only when its injection
        actually LANDED (a kill delivered, a live connection dropped).  A
        no-op attempt (target already a corpse mid-backoff, no live
        connection) stays pending: it retries next phase, and if it never
        lands, ``unfired()`` reports it — recording a no-op would read as
        a drill that passed without its fault ever being injected."""
        for fault in self.faults:
            if (
                fault.kind not in LEARNER_FAULTS
                or fault.index in self._fired
                or phase < fault.phase
            ):
                continue
            target = fault_target(fault, self.seed, self.num_actors)
            if fault.kind == "kill_actor":
                killed = (
                    self.supervisor is not None
                    and self.supervisor.kill_actor(target)
                )
                if not killed:
                    continue
                self._fired.add(fault.index)
                record_injection(fault, target, at_phase=phase)
            elif fault.kind in ("kill_ingest_conn", "kill_sampler_conn"):
                # kill_sampler_conn shares the boundary (a learner-side
                # socket close) but names the SAMPLER peer class: the
                # dropped connection is the one feeding the target
                # actor's replay shard — the drill asserts the shard's
                # DATA survives and only the in-flight batch (plus its
                # re-banked accounting) is lost.
                dropped = (
                    self.server.drop_connection(actor=str(target))
                    if self.server is not None
                    else None
                )
                if dropped is None:
                    continue
                self._fired.add(fault.index)
                record_injection(
                    fault, target, at_phase=phase, dropped=dropped
                )
            elif fault.kind == "stall_sampler":
                # The stall IS the fault: the pull loop (this thread)
                # stops sampling for the duration.  Recorded BEFORE the
                # sleep so evidence survives however the drill ends.
                self._fired.add(fault.index)
                record_injection(
                    fault, target, at_phase=phase,
                    duration_s=fault.duration_s,
                )
                time.sleep(fault.duration_s)
            elif fault.kind == "kill_shard":
                # SIGKILL one standalone shard PROCESS (target re-derived
                # modulo the tier's proc count): the drill the whole tier
                # exists to survive — quotas renormalize to the survivors
                # within a phase, handlers re-route, and the supervisor's
                # backoff restart rejoins the shard under a bumped epoch.
                tier = self.shard_tier
                if tier is None:
                    continue
                target = fault_target(fault, self.seed, tier.num_procs)
                if not tier.kill_proc(target):
                    continue
                self._fired.add(fault.index)
                record_injection(fault, target, at_phase=phase)
            elif fault.kind == "partition_shard":
                # Drop BOTH legs' connections to one shard (target modulo
                # the SHARD count — the connection unit): a network
                # partition, not a restart.  Recovery is reconnection on
                # both legs with the shard's data intact under the SAME
                # epoch.
                tier = self.shard_tier
                if tier is None:
                    continue
                target = fault_target(fault, self.seed, tier.num_shards)
                if not tier.shard_set.partition(target):
                    continue  # no live connection yet: stays pending
                self._fired.add(fault.index)
                record_injection(fault, target, at_phase=phase)

    def unfired(self) -> Tuple[Fault, ...]:
        """Learner-side faults whose phase never arrived (run too short):
        callers log these so a drill that never ran cannot read as one
        that passed."""
        return tuple(
            f
            for f in self.faults
            if f.kind in LEARNER_FAULTS and f.index not in self._fired
        )


def _faults_unfired_in_dumps(
    faults: Sequence[Fault],
    logdir: str,
    *,
    pattern: str,
    kinds: frozenset,
    seed: int,
    n: int,
) -> Tuple[Fault, ...]:
    """The shared no-evidence-means-unfired scan: faults of ``kinds``
    with no ``chaos_inject`` line in the ``pattern`` flight dumps under
    ``logdir``.  Evidence is matched on (kind, phase, target) — ``seed``
    and ``n`` recompute each fault's target — so duplicate spec entries
    hashing to different targets each need their own line."""
    expected = [f for f in faults if f.kind in kinds]
    if not expected:
        return ()
    seen = set()
    for path in glob.glob(os.path.join(logdir, pattern)):
        try:
            with open(path) as fh:
                for line in fh:
                    try:
                        e = json.loads(line)
                    except ValueError:
                        continue
                    if e.get("kind") == "chaos_inject":
                        seen.add(
                            (e.get("fault"), e.get("phase"), e.get("actor"))
                        )
        except OSError:
            continue
    return tuple(
        f
        for f in expected
        if (f.kind, f.phase, fault_target(f, seed, n)) not in seen
    )


def actor_faults_unfired(
    faults: Sequence[Fault], logdir: str, *, seed: int, num_actors: int
) -> Tuple[Fault, ...]:
    """Actor-boundary faults of a spec with NO injection evidence in the
    ``flight_actor*.jsonl`` dumps under ``logdir``.

    The learner-side engine cannot see an actor process fire (or fail to
    fire) its drills; what it CAN see, after teardown has flushed every
    incarnation's dump, is whether a ``chaos_inject`` line exists for each
    scheduled actor-side fault — ``record_injection`` flushes at injection
    time precisely so this evidence survives any way the drill ends.
    Callers warn on the returned faults: a drill that left no evidence
    must not read as one that passed (the ``unfired()`` contract)."""
    return _faults_unfired_in_dumps(
        faults,
        logdir,
        pattern="flight_actor*.jsonl",
        kinds=ACTOR_FAULTS,
        seed=seed,
        n=num_actors,
    )


class ActorChaos:
    """Actor-side scheduler: the faults of a forwarded spec that target
    THIS actor, fired on its emitted-batch clock (``FleetActor.run``).

    A supervised restart re-parses the same argv, so a restarted
    incarnation re-arms its schedule — harmless for the drill semantics
    (a stall is just slow; a corrupt frame re-drills the same recovery)
    and exactly what a deterministic schedule means."""

    def __init__(
        self, faults: Sequence[Fault], *, seed: int, num_actors: int, actor_id: int
    ):
        self.actor_id = actor_id
        self._mine = tuple(
            f
            for f in faults
            if f.kind in ACTOR_FAULTS
            and fault_target(f, seed, num_actors) == actor_id
        )
        self._fired = set()

    def maybe_stall(self, batch_idx: int) -> float:
        """Sleep out any due ``stall_actor`` fault (before collecting batch
        ``batch_idx``); returns seconds slept.  The sleep IS the fault: the
        actor stops reading and sending, so the ingest handler's heartbeat
        deadline reaps it as ``peer_dead``."""
        slept = 0.0
        for f in self._due("stall_actor", batch_idx):
            self._fired.add(f.index)
            record_injection(f, self.actor_id, at_phase=batch_idx)
            time.sleep(f.duration_s)
            slept += f.duration_s
        return slept

    def corrupt_next_frame(self, batch_idx: int) -> bool:
        """True when batch ``batch_idx``'s SEQS frame should go out through
        ``send_corrupt_frame`` (fires each due corrupt fault once)."""
        due = self._due("corrupt_frame", batch_idx)
        for f in due:
            self._fired.add(f.index)
            record_injection(f, self.actor_id, at_phase=batch_idx)
        return bool(due)

    def partition_data_plane(self, batch_idx: int) -> bool:
        """True when the direct data leg should be severed before batch
        ``batch_idx`` (fires each due partition fault once) — the actor
        shuts the socket down but keeps the reference, so the coming
        direct push fails mid-send like a real network partition and the
        loud-fallback recovery path runs."""
        due = self._due("partition_data_plane", batch_idx)
        for f in due:
            self._fired.add(f.index)
            record_injection(f, self.actor_id, at_phase=batch_idx)
        return bool(due)

    def _due(self, kind: str, batch_idx: int):
        return [
            f
            for f in self._mine
            if f.kind == kind
            and f.index not in self._fired
            and batch_idx >= f.phase
        ]


class ShardChaos:
    """Shard-process-side scheduler (fleet/shard.py): the
    ``stall_shard`` faults of a forwarded spec that target THIS shard
    process, fired on its absorbed-SEQS-frame clock.

    The stall is a RESPONSE gate, not a sleep in one handler: every leg's
    handler waits out the gate before replying (acks, BATCH responses),
    so for the duration the whole shard is unresponsive on every
    connection — exactly what a GC pause or an I/O wedge looks like from
    the learner side.  The drill's pinned property is that NOTHING breaks:
    actors keep streaming into the (eventually-answered) ack wait, the
    sampler waits out its exchange, zero sheds, zero false reaps."""

    def __init__(
        self,
        faults: Sequence[Fault],
        *,
        seed: int,
        num_shard_procs: int,
        proc_index: int,
    ):
        self.proc_index = proc_index
        self._mine = tuple(
            f
            for f in faults
            if f.kind in SHARD_PROC_FAULTS
            and fault_target(f, seed, num_shard_procs) == proc_index
        )
        self._fired = set()
        self._frames = 0
        self._stall_until = 0.0
        self._lock = threading.Lock()

    def on_seqs_frame(self) -> None:
        """One absorbed SEQS frame (any connection): advance the clock and
        arm any due stall (recorded at arm time — evidence survives
        however the drill ends)."""
        with self._lock:
            self._frames += 1
            for f in self._mine:
                if f.index in self._fired or self._frames < f.phase:
                    continue
                self._fired.add(f.index)
                record_injection(
                    f, self.proc_index, at_phase=self._frames,
                    duration_s=f.duration_s,
                )
                self._stall_until = max(
                    self._stall_until, time.monotonic() + f.duration_s
                )

    def gate(self) -> None:
        """Wait out any armed stall before replying (every handler calls
        this ahead of each ACK/BATCH send)."""
        delay = self._stall_until - time.monotonic()
        if delay > 0:
            time.sleep(delay)


def shard_faults_unfired(
    faults: Sequence[Fault], logdir: str, *, seed: int, num_shard_procs: int
) -> Tuple[Fault, ...]:
    """Shard-process-boundary faults of a spec with NO injection evidence
    in the ``flight_shard*.jsonl`` dumps under ``logdir`` — the
    ``actor_faults_unfired`` contract extended to the shard tier (a
    stall drill that never got its frame count must not read as one that
    passed)."""
    return _faults_unfired_in_dumps(
        faults,
        logdir,
        pattern="flight_shard*.jsonl",
        kinds=SHARD_PROC_FAULTS,
        seed=seed,
        n=num_shard_procs,
    )
