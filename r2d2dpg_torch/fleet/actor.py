"""Fleet actor: an out-of-process collector streaming experience upstream.

Port of the learner-forwarded part of ``r2d2dpg_tpu/fleet/actor.py``.  One
actor process owns its env lanes (``--num-envs``) and a stale copy of the
learner's nets, runs the R2D2-DPG rollout, ranks its sequences locally
with those stale nets (Ape-X §3: sequences enter replay already ranked),
and streams one ``replay.StagedSequences`` batch per collect phase to the
learner's ingest server, applying versioned param updates between phases
and ignoring regressions (a delayed PARAMS frame must never roll the
policy backwards).

Exploration: actor ``i`` of ``N`` gets its own slice of the sigma ladder,
which spans the GLOBAL ``num_actors * num_envs`` lanes
(``FleetActorTrainer._local_sigmas``), so a 3-actor fleet explores like
one 3x-wider in-process batch.

Random numbers: actor ``i`` draws from a ``Draws`` seeded with
``actor_seed(seed, i)``, ``(seed + 0x9E3779B97F4A7C15 * (i + 1)) % 2**63``
(the JAX actor folds its index into the key instead), so a fleet at seed
S is a different trajectory per actor, never N copies of one rollout.
The initial nets are the config seed's, as the learner's; version 1 of the
learner's params replaces them before the first collect phase.

The actor's tensors live on ``--device`` (``cuda`` unless given, as every
entry point of the port); the spawner (``fleet/supervisor.py``) always
passes ``--device cpu`` and hides the card from the child, so no actor
opens a CUDA context on the learner's card.  Frames leave as numpy: one
batched device-to-host copy per phase (``transport.to_host``).

Under ``--replay-shards`` the learner's ingest server routes the actor's
SEQS batches into replay shards and always acks ``OK``.  With
``--shard-direct 1`` the actor dials the shard the learner advertises on
its acks and ships SEQS there itself; the control connection then carries
one small K_STATS frame of accounting per phase, and any failure of the
data leg falls back loudly to the learner-forwarded path.  ``--chaos-spec``
arms the actor-side drills that target this actor (``fleet/chaos.py``:
``stall_actor``, ``corrupt_frame``, ``partition_data_plane``).  With
``--telem-every S`` (the train CLI's ``--obs-fleet`` spawns ``1.0``) the
actor pushes its registry snapshot to the learner as a fire-and-forget
TELEM frame every S seconds: forced right after HELLO, then on the
warm-up and collect cadence, so a wedged actor's silence is the signal.

CLI (spawned by the supervisor; runnable by hand for debugging)::

    python -m r2d2dpg_torch.fleet.actor --config pendulum_tiny \\
        --connect 127.0.0.1:7450 --actor-id 0 --num-actors 3 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import socket
import sys
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from r2d2dpg_torch.configs import CONFIGS, ExperimentConfig, get_config
from r2d2dpg_torch.device import resolve_device
from r2d2dpg_torch.fleet import chaos as fleet_chaos
from r2d2dpg_torch.fleet import wire
from r2d2dpg_torch.fleet.transport import (
    HEADER_BYTES,
    K_ACK,
    K_BYE,
    K_HELLO,
    K_PARAMS,
    K_SEQS,
    K_STATS,
    K_TELEM,
    MAX_FRAME_BYTES,
    READ_DEADLINE_S,
    WARMUP_DEADLINE_S,
    FrameError,
    PeerDeadError,
    connect,
    hello_auth_proof,
    pack_hello,
    pack_obj,
    recv_frame_heartbeat,
    send_frame,
    send_frame_parts,
    to_host,
    unpack_obj,
)
from r2d2dpg_torch.obs import flight_event, get_registry, set_flight_identity
from r2d2dpg_torch.obs import trace as obs_trace
from r2d2dpg_torch.ops import sigma_ladder
from r2d2dpg_torch.replay.arena import StagedSequences
from r2d2dpg_torch.training.assembler import emit
from r2d2dpg_torch.training.draws import Draws
from r2d2dpg_torch.training.pipeline import split_state
from r2d2dpg_torch.training.trainer import Trainer, TrainerConfig
from r2d2dpg_torch.utils.codes import (
    EXIT_AUTH_REFUSED,
    EXIT_WIRE_REFUSED,
    OK,
    REFUSED_AUTH,
    REFUSED_WIRE,
    SHED_INGEST,
)

_SEED_MULT = 0x9E3779B97F4A7C15
_PARAM_FIELDS = (
    "actor_params", "critic_params", "target_actor_params", "target_critic_params",
)


def actor_seed(seed: int, actor_id: int) -> int:
    """The seed of actor ``actor_id``'s draws (module docstring)."""
    return (int(seed) + _SEED_MULT * (int(actor_id) + 1)) % 2**63


class FleetActorTrainer(Trainer):
    """A ``Trainer`` whose noise ladder is one actor's slice of the fleet's.

    Everything else (collect, window assembler, episode accounting) is the
    base trainer: the actor IS a collector, with ``num_envs`` local lanes of
    a ``num_actors * num_envs``-lane fleet."""

    def __init__(
        self,
        env,
        agent,
        config: TrainerConfig,
        device: torch.device,
        *,
        actor_index: int,
        num_actors: int,
    ):
        if not 0 <= actor_index < num_actors:
            raise ValueError(
                f"actor_index {actor_index} outside fleet of {num_actors}"
            )
        self.actor_index = actor_index
        self.num_actors = num_actors
        super().__init__(env, agent, config, device)

    def _local_sigmas(self) -> torch.Tensor:
        cfg = self.config
        sigmas = sigma_ladder(
            self.num_actors * cfg.num_envs,
            sigma_max=cfg.sigma_max,
            alpha=cfg.ladder_alpha,
            kind=cfg.ladder_kind,
            device=self.device,
        )
        lo = self.actor_index * cfg.num_envs
        return sigmas[lo : lo + cfg.num_envs]


def build_actor_trainer(
    exp: ExperimentConfig, *, actor_index: int, num_actors: int, device=None
) -> FleetActorTrainer:
    """The actor's trainer: the full net/agent recipe and a TINY arena (the
    actor never samples; replay lives learner-side)."""
    device = resolve_device(device)
    env = exp.env_factory(device)
    agent = exp.build_agent(env)
    tcfg = dataclasses.replace(
        exp.trainer, capacity=max(exp.trainer.num_envs, 1), min_replay=1
    )
    return FleetActorTrainer(
        env, agent, tcfg, device, actor_index=actor_index, num_actors=num_actors
    )


# Reconnect-with-backoff: a torn connection is retried in-process (the
# delay doubling from the base to the cap) before the actor gives the
# incarnation up to the supervisor.
RECONNECT_TRIES = 4
RECONNECT_BASE_S = 0.5
RECONNECT_MAX_S = 10.0


class FleetActor:
    """The worker loop: collect -> rank -> stream -> apply params."""

    def __init__(
        self,
        exp: ExperimentConfig,
        *,
        actor_id: int,
        num_actors: int,
        address: str,
        seed: Optional[int] = None,
        wire_config: Optional[wire.WireConfig] = None,
        max_frame_bytes: int = MAX_FRAME_BYTES,
        telem_every: float = 0.0,
        trace_sample: float = 0.0,
        read_deadline_s: float = READ_DEADLINE_S,
        auth_token: Optional[str] = None,
        shard_direct: bool = False,
        chaos_spec: Optional[str] = None,
        device=None,
    ):
        self.actor_id = actor_id
        self.address = address
        # Liveness bound on this end of the wire: until a session's first
        # ack the larger deadline applies (the learner's first drain may
        # park the handler in a queue-full wait, which is not a dead peer).
        self.read_deadline_s = read_deadline_s
        self.warmup_deadline_s = max(WARMUP_DEADLINE_S, read_deadline_s)
        self.auth_token = auth_token
        # TELEM cadence in seconds (0 = off) and the experience-path trace
        # sampling rate (0 = off).
        self.telem_every = float(telem_every)
        self.trace_sample = float(trace_sample)
        self._telem_last = 0.0
        # Must mirror the learner's --fleet-wire/--fleet-compress and frame
        # ceiling: the ingest server refuses a mismatched HELLO.
        self.wire_config = (wire_config or wire.WireConfig()).validate()
        self.max_frame_bytes = max_frame_bytes
        self.trainer = build_actor_trainer(
            exp, actor_index=actor_id, num_actors=num_actors, device=device
        )
        t = self.trainer
        self.device = t.device
        seed = t.config.seed if seed is None else seed
        state = t.init(Draws(actor_seed(seed, actor_id), t.device))
        self._cstate, lstate = split_state(state)
        # The stale learner-net copy: acts AND ranks until the first PARAMS
        # frame lands (version 0 = own init).
        self._train = lstate.train
        self._param_version = 0
        self._sheds = 0
        self._phase = 0
        self._batches = 0  # emitted (post-warm-up) batches: the chaos clock
        # Orderly drain (SIGUSR1 or request_drain): the session loop exits
        # after the current phase's ack lands, then sends BYE.
        self._drain = threading.Event()
        self._last_env_steps = 0.0
        # At-least-once stats accounting: the per-phase deltas ride the SEQS
        # message and are cleared only once an ack proves the server owns
        # them; a connection lost before the ack re-banks them.
        self._pending_stats = {
            "env_steps_delta": 0.0, "ep_return_sum": 0.0, "ep_count": 0.0,
        }
        # Direct data plane: the leg to the advertised shard (None = ship
        # on the control connection).  _pending_stats is cleared only on a
        # control ack, so the accounting does not depend on the plane.
        self.shard_direct = bool(shard_direct)
        self._assignment: Optional[dict] = None  # last dialed advert
        self._failed_assignment: Optional[dict] = None  # not re-dialed
        self._data_sock = None
        self._data_packer: Optional[wire.TreePacker] = None
        self._data_epoch = -1  # epoch the dialed advert carried
        # The forwarded --chaos-spec's actor-side drills that target this
        # actor; ``seed`` is the value the learner's engine hashes too.
        self.chaos: Optional[fleet_chaos.ActorChaos] = None
        if chaos_spec:
            self.chaos = fleet_chaos.ActorChaos(
                fleet_chaos.parse_chaos_spec(chaos_spec),
                seed=seed,
                num_actors=num_actors,
                actor_id=actor_id,
            )
        self._local_priorities = (
            t.config.prioritized and t.config.initial_priority == "td"
        )
        reg = get_registry()
        self._obs_phases = reg.counter(
            "r2d2dpg_actor_phases_total", "collect phases completed"
        )
        self._obs_shed = reg.counter(
            "r2d2dpg_actor_shed_total", "batches the ingest server shed"
        )
        self._obs_version = reg.gauge(
            "r2d2dpg_actor_param_version", "last applied param version"
        )
        self._obs_bytes_out = reg.counter(
            "r2d2dpg_actor_bytes_out_total",
            "bytes this actor put on the fleet wire (frames + headers)",
        )
        self._obs_bytes_in = reg.counter(
            "r2d2dpg_actor_bytes_in_total",
            "bytes this actor received off the fleet wire (acks + params)",
        )
        self._obs_telem = reg.counter(
            "r2d2dpg_actor_telem_sent_total",
            "TELEM registry snapshots pushed to the learner's ingest",
        )
        self._obs_reconnects = reg.counter(
            "r2d2dpg_actor_reconnects_total",
            "successful in-process reconnects after a torn connection "
            "(fresh socket + HELLO + param snapshot, same incarnation)",
        )
        # The data leg's bytes land here and only here, never in the
        # actor totals above, so control and data traffic stay separable.
        self._obs_data_out = reg.counter(
            "r2d2dpg_fleet_data_bytes_out_total",
            "bytes sent on the direct actor->shard data plane",
            labelnames=("plane",),
        ).labels(plane="data")
        self._obs_data_in = reg.counter(
            "r2d2dpg_fleet_data_bytes_in_total",
            "bytes received on the direct actor->shard data plane",
            labelnames=("plane",),
        ).labels(plane="data")
        self._obs_fallback = reg.counter(
            "r2d2dpg_actor_data_fallback_total",
            "direct data-plane failures that fell back to the "
            "learner-forwarded path (dial refused, torn leg, partition)",
        )
        self._session_delivered = False

    # -------------------------------------------------------------- params
    def maybe_apply_params(self, msg: Any) -> bool:
        """Apply a versioned snapshot; IGNORE stale or replayed versions.

        The regression guard: acks and pushes can interleave across a
        reconnect, and a policy must only ever move forward."""
        version = int(msg["version"])
        if version <= self._param_version:
            flight_event(
                "param_regression_ignored",
                got=version,
                have=self._param_version,
            )
            return False
        # Decoded leaves may be read-only views over the frame: copy each
        # once, here, into a tensor on this actor's device.
        p = msg["params"]
        self._train = dataclasses.replace(self._train, **{
            f: {k: torch.from_numpy(np.array(v)).to(self.device)
                for k, v in p[f].items()}
            for f in _PARAM_FIELDS})
        self._param_version = version
        self._obs_version.set(float(version))
        return True

    # ------------------------------------------------------------ one phase
    def collect_phase(self) -> Optional[StagedSequences]:
        """One stride of env steps; returns the emitted batch (None during
        window warm-up, when the window still holds init padding)."""
        t = self.trainer
        behavior = self._train.actor_params
        critic = t.agent.behavior_critic_params(self._train)
        self._cstate = t._collect(
            self._cstate, behavior=behavior, critic_params=critic
        )
        self._phase += 1
        self._obs_phases.inc()
        if self._phase <= t.window_fill_phases:
            return None
        seq = emit(self._cstate.window)
        prios = (
            t.agent.initial_priority(self._train, seq)
            if self._local_priorities
            else None
        )
        return StagedSequences(seq=seq, priorities=prios)

    def host_batch(self) -> Optional[StagedSequences]:
        """One collect phase as the numpy batch a SEQS frame carries, with
        its provenance; folds the phase's episode deltas into the pending
        stats.  None during warm-up.

        ONE device-to-host copy per phase: the episode accumulators, the
        staged sequences and their priorities together."""
        staged = self.collect_phase()
        if staged is None:
            return None
        cs = self._cstate
        (ret_sum, count), seq_host, prios_host = to_host(
            ((cs.completed_return_sum, cs.completed_count),
             staged.seq, staged.priorities)
        )
        zero = torch.zeros((), device=self.device)
        self._cstate = dataclasses.replace(
            cs, completed_return_sum=zero, completed_count=zero.clone()
        )
        # Deltas, not cumulative sums: a supervised restart resets this
        # process, and the learner's sums must stay monotone.
        env_steps = float(cs.env_steps)
        self._pending_stats["env_steps_delta"] += env_steps - self._last_env_steps
        self._last_env_steps = env_steps
        self._pending_stats["ep_return_sum"] += float(ret_sum)
        self._pending_stats["ep_count"] += float(count)
        b = seq_host.reward.shape[0]
        return StagedSequences(
            seq=seq_host,
            priorities=prios_host,
            behavior_version=np.full((b,), self._param_version, np.int64),
            collect_id=np.full((b,), self._phase, np.int64),
        )

    # ------------------------------------------------------------------ run
    def request_drain(self) -> None:
        """Leave the fleet cleanly: finish the current phase (its ack folds
        the pending accounting), send BYE, return.  Idempotent."""
        if not self._drain.is_set():
            self._drain.set()
            flight_event("actor_drain", phase=self._phase)

    def run(self, max_phases: Optional[int] = None) -> None:
        """Stream until the server goes away (orderly end) or an
        unrecoverable error surfaces (nonzero exit; the supervisor
        restarts the process).

        A torn connection is retried in-process first, with exponential
        backoff: fresh socket, HELLO and wire schema cache, the collection
        state kept.  After ``RECONNECT_TRIES`` consecutive failed sessions
        the error propagates."""
        attempts = 0
        backoff = RECONNECT_BASE_S
        while True:
            self._session_delivered = False
            try:
                self._run_session(max_phases, reconnected=attempts > 0)
                return
            except (_OrderlyShutdown, _WireRefused, _AuthRefused):
                raise  # deterministic verdicts: never retried here
            except (FrameError, OSError) as e:
                if isinstance(e, PeerDeadError):
                    flight_event(
                        "peer_dead",
                        phase=self._phase,
                        deadline_s=self.read_deadline_s,
                        error=str(e),
                    )
                if self._session_delivered:
                    # Only CONSECUTIVE failures walk toward giving up.
                    attempts = 0
                    backoff = RECONNECT_BASE_S
                attempts += 1
                if attempts > RECONNECT_TRIES:
                    raise
                flight_event(
                    "actor_reconnect_wait",
                    phase=self._phase,
                    attempt=attempts,
                    backoff_s=round(backoff, 3),
                    error=f"{type(e).__name__}: {e}",
                )
                time.sleep(backoff)
                backoff = min(backoff * 2, RECONNECT_MAX_S)

    def _run_session(
        self, max_phases: Optional[int], *, reconnected: bool = False
    ) -> None:
        """One connection's lifetime: HELLO -> stream -> BYE."""
        sock = connect(self.address, read_deadline_s=self.warmup_deadline_s)
        # Wire state lives and dies with the socket: a reconnect's first
        # SEQS frame re-inlines its schema.
        packer = wire.TreePacker(
            self.wire_config, max_frame_bytes=self.max_frame_bytes
        )
        self._unpacker = wire.TreeUnpacker(
            max_frame_bytes=self.max_frame_bytes
        )
        try:
            hello = {
                "actor_id": self.actor_id,
                "num_envs": self.trainer.config.num_envs,
                **wire.negotiation_fields(self.wire_config),
            }
            if self.auth_token is not None:
                hello["auth"] = hello_auth_proof(self.auth_token)
            self._obs_bytes_out.inc(
                send_frame(
                    sock,
                    K_HELLO,
                    pack_hello(hello),  # JSON: parsed pre-auth on the far end
                    max_frame_bytes=self.max_frame_bytes,
                )
            )
            hello_ack = self._await_ack(sock)
            if hello_ack.get("code") == REFUSED_WIRE:
                raise _WireRefused(
                    f"ingest refused wire negotiation "
                    f"({hello_ack.get('reason')}); launch this actor with "
                    f"the learner's --fleet-wire/--fleet-compress "
                    f"(server expects {hello_ack.get('expect')})"
                )
            if hello_ack.get("code") == REFUSED_AUTH:
                raise _AuthRefused(
                    "ingest refused HELLO authentication; launch this "
                    "actor with the learner's --fleet-token"
                )
            if reconnected:
                flight_event("actor_reconnect", phase=self._phase)
                self._obs_reconnects.inc()
            # The HELLO ack may carry the shard advert: dial before the
            # first phase so batch one already skips the forward hop.
            self._maybe_update_assignment(hello_ack)
            self._maybe_send_telem(sock, force=True)
            while (
                max_phases is None or self._phase < max_phases
            ) and not self._drain.is_set():
                if self.chaos is not None:
                    # stall_actor: stop reading and sending, so the ingest
                    # handler's heartbeat reaps this connection.
                    self.chaos.maybe_stall(self._batches + 1)
                    if self.chaos.partition_data_plane(self._batches + 1):
                        self._partition_data_plane()
                # Trace sampling decided at collection time: rate 0 adds
                # nothing, and the frame is byte-identical to an untraced one.
                tr = obs_trace.maybe_start(self.trace_sample)
                staged_host = self.host_batch()
                if staged_host is None:
                    # Warm-up: the TELEM cadence still ticks, or the
                    # warm-up phases would read as a wedged actor.
                    self._maybe_send_telem(sock)
                    continue
                self._batches += 1
                if tr is not None:
                    tr.t_collect_end = time.time()
                if self._data_sock is not None and self._send_direct(
                    staged_host
                ):
                    # The shard owns the experience; the accounting rides
                    # a K_STATS frame, acked like SEQS.
                    self._obs_bytes_out.inc(
                        send_frame(
                            sock,
                            K_STATS,
                            pack_obj(  # wire-lint: control
                                {
                                    "phase": self._phase,
                                    "param_version": self._param_version,
                                    **self._pending_stats,
                                }
                            ),
                            max_frame_bytes=self.max_frame_bytes,
                        )
                    )
                else:
                    # The learner-forwarded path (and the fallback: a batch
                    # whose direct push failed goes here, nothing dropped).
                    parts = packer.pack(
                        {
                            "phase": self._phase,
                            "param_version": self._param_version,
                            **self._pending_stats,
                            "staged": staged_host,
                        },
                        trace=tr,
                    )
                    if self.chaos is not None and (
                        self.chaos.corrupt_next_frame(self._batches)
                    ):
                        # Pristine CRC over one flipped byte: the server
                        # must reject the frame and close the connection.
                        sent = fleet_chaos.send_corrupt_frame(
                            sock, K_SEQS, parts
                        )
                    else:
                        sent = send_frame_parts(
                            sock,
                            K_SEQS,
                            parts,
                            max_frame_bytes=self.max_frame_bytes,
                        )
                    self._obs_bytes_out.inc(sent)
                ack = self._await_ack(sock)
                # Acked (OK or shed): the server owns the accounting now.
                for k in self._pending_stats:
                    self._pending_stats[k] = 0.0
                if not self._session_delivered:
                    # First ack: warm-up is over, arm the steady deadline.
                    sock.settimeout(self.read_deadline_s)
                self._session_delivered = True
                if ack["code"] == SHED_INGEST:
                    self._sheds += 1
                    self._obs_shed.inc()
                # Any control ack may carry a new advert (a shard that
                # rejoined under a bumped epoch); an unchanged one on a
                # live leg is a no-op.
                self._maybe_update_assignment(ack)
                self._maybe_send_telem(sock)
            try:
                send_frame(sock, K_BYE, b"")  # wire-lint: control
            except OSError:
                pass
        finally:
            # The data leg lives and dies with the control session: a
            # reconnect re-dials from the fresh HELLO ack's advert.
            self._drop_data_plane(reason=None)
            try:
                sock.close()
            except OSError:
                pass

    def _maybe_send_telem(self, sock, force: bool = False) -> None:
        """Push this process's registry snapshot as a TELEM frame when
        ``telem_every`` seconds have passed (or ``force``).  No ack: the
        next SEQS ack paces the connection."""
        if self.telem_every <= 0.0:
            return
        now = time.monotonic()
        if not force and now - self._telem_last < self.telem_every:
            return
        self._telem_last = now
        self._obs_telem.inc()
        self._obs_bytes_out.inc(
            send_frame(
                sock,
                K_TELEM,
                pack_obj(  # wire-lint: control
                    {
                        "actor_id": self.actor_id,
                        "host": socket.gethostname(),
                        "t_wall": time.time(),
                        "snapshot": get_registry().snapshot(),
                    }
                ),
                max_frame_bytes=self.max_frame_bytes,
            )
        )

    # ------------------------------------------------- direct data plane
    def _maybe_update_assignment(self, ack: Any) -> None:
        """Track the learner's shard advert and (re)dial when it changes.

        Adverts ride control acks, so this runs at most once a phase.  An
        advert equal to the last FAILED one is skipped (no hammering a
        refusing shard); a rejoined shard is re-advertised under a bumped
        epoch, which unsticks it."""
        if not self.shard_direct or not isinstance(ack, dict):
            return
        advert = ack.get("shard_assignment")
        if not isinstance(advert, dict) or advert == self._failed_assignment:
            return
        if (
            self._data_sock is not None
            and self._assignment is not None
            and advert.get("address") == self._assignment.get("address")
            and int(advert.get("epoch", -1)) == self._data_epoch
        ):
            return  # same shard incarnation, leg already live
        self._dial_data_plane(advert)

    def _dial_data_plane(self, advert: dict) -> bool:
        """Connect to the advertised shard, send a ``plane="data"`` HELLO
        (the control HELLO's token) and wait for its OK.  A refusal or a
        dead address is loud but not fatal: the forwarded path goes on."""
        address = str(advert.get("address") or "")
        if not address:
            return False
        self._drop_data_plane(reason=None)  # replace any previous leg
        sock = None
        try:
            sock = connect(address, read_deadline_s=self.read_deadline_s)
            hello = {
                "actor_id": self.actor_id,
                "plane": "data",
                **wire.negotiation_fields(self.wire_config),
            }
            if self.auth_token is not None:
                hello["auth"] = hello_auth_proof(self.auth_token)
            self._obs_data_out.inc(
                send_frame(
                    sock,
                    K_HELLO,
                    pack_hello(hello),
                    max_frame_bytes=self.max_frame_bytes,
                )
            )
            hello_ack = self._await_data_ack(sock)
            if hello_ack.get("code") != OK:
                raise FrameError(
                    f"shard refused data-plane HELLO: "
                    f"code={hello_ack.get('code')} "
                    f"reason={hello_ack.get('reason')}"
                )
        except (FrameError, OSError) as e:
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
            self._failed_assignment = dict(advert)
            self._obs_fallback.inc()
            flight_event(
                "data_plane_dial_failed",
                phase=self._phase,
                shard=advert.get("shard"),
                address=address,
                error=f"{type(e).__name__}: {e}",
            )
            return False
        self._data_sock = sock
        # Fresh packer per leg: its first SEQS frame re-inlines the schema.
        self._data_packer = wire.TreePacker(
            self.wire_config, max_frame_bytes=self.max_frame_bytes
        )
        self._data_epoch = int(advert.get("epoch", -1))
        self._assignment = dict(advert)
        self._failed_assignment = None
        flight_event(
            "data_plane_dialed",
            phase=self._phase,
            shard=advert.get("shard"),
            address=address,
            epoch=self._data_epoch,
        )
        return True

    def _send_direct(self, staged: StagedSequences) -> bool:
        """Ship one batch straight to the shard; True once its ack lands.
        Any failure tears the leg down loudly and returns False, and the
        caller sends the SAME batch on the control connection."""
        try:
            parts = self._data_packer.pack({"staged": staged})
            self._obs_data_out.inc(
                send_frame_parts(
                    self._data_sock,
                    K_SEQS,
                    parts,
                    max_frame_bytes=self.max_frame_bytes,
                )
            )
            ack = self._await_data_ack(self._data_sock)
            if ack.get("code") != OK:
                raise FrameError(
                    f"shard data-plane ack code {ack.get('code')}"
                )
            return True
        except (FrameError, OSError) as e:
            self._drop_data_plane(reason=f"{type(e).__name__}: {e}")
            return False

    def _await_data_ack(self, sock) -> Any:
        """Read to the shard's next ACK on the data leg.  The shard rides
        TELEM pushes on any authenticated connection; the learner is their
        consumer, so here they are counted and dropped."""
        while True:
            kind, payload = recv_frame_heartbeat(
                sock,
                max_frame_bytes=self.max_frame_bytes,
                bytes_in=self._obs_data_in.inc,
                bytes_out=self._obs_data_out.inc,
            )
            self._obs_data_in.inc(HEADER_BYTES + len(payload))
            if kind == K_TELEM:
                continue
            if kind == K_ACK:
                return unpack_obj(payload)  # wire-lint: control
            raise FrameError(f"unexpected data-plane frame kind {kind}")

    def _drop_data_plane(self, reason: Optional[str]) -> None:
        """Tear the data leg down.  A reason means a failure (the
        ``data_plane_fallback`` event and the fallback counter); None is
        lifecycle (session end, a re-dial replacing the leg)."""
        sock, self._data_sock = self._data_sock, None
        self._data_packer = None
        self._assignment = None
        self._data_epoch = -1
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        if reason is not None:
            self._obs_fallback.inc()
            flight_event("data_plane_fallback", phase=self._phase, error=reason)

    def _partition_data_plane(self) -> None:
        """``partition_data_plane``: shut the leg down both ways but keep
        the reference, so the next direct send fails mid-send as under a
        real partition, not at dial time."""
        if self._data_sock is None:
            return
        try:
            self._data_sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    def _await_ack(self, sock) -> Any:
        """Read to the next ACK, applying any PARAMS pushed ahead of it
        (the server orders PARAMS-then-ACK, so a fresh snapshot is live
        before the next collect phase).  Deadline-aware: a learner silent
        past the read deadline is PINGed once and declared dead on a second
        silence."""
        while True:
            kind, payload = recv_frame_heartbeat(
                sock,
                max_frame_bytes=self.max_frame_bytes,
                bytes_in=self._obs_bytes_in.inc,
                bytes_out=self._obs_bytes_out.inc,
            )
            self._obs_bytes_in.inc(HEADER_BYTES + len(payload))
            if kind == K_PARAMS:
                self.maybe_apply_params(self._unpacker.unpack(payload))
                continue
            if kind == K_ACK:
                return unpack_obj(payload)  # wire-lint: control
            if kind == K_BYE:
                raise _OrderlyShutdown()
            raise FrameError(f"unexpected frame kind {kind}")


class _OrderlyShutdown(Exception):
    """Server said BYE mid-stream: exit 0, nothing crashed."""


class _WireRefused(FrameError):
    """HELLO refused on the wire lane: deterministic misconfiguration.
    Exits ``EXIT_WIRE_REFUSED``, so the supervisor gives the slot up."""


class _AuthRefused(FrameError):
    """HELLO refused on the --fleet-token proof; exits
    ``EXIT_AUTH_REFUSED`` (same terminal contract as ``_WireRefused``)."""


# ---------------------------------------------------------------------- CLI
def structural_argv(exp: ExperimentConfig):
    """The actor flags that must MIRROR the learner's resolved config: the
    net/param-tree structure and the exploration ladder.  The single source
    for the spawner (``train.py`` forwards exactly this)."""
    return [
        "--num-envs", str(exp.trainer.num_envs),
        "--n-step", str(exp.agent.n_step),
        "--twin-critic", "1" if exp.agent.twin_critic else "0",
        "--sigma-max", str(exp.trainer.sigma_max),
        "--ladder-alpha", str(exp.trainer.ladder_alpha),
        "--compute-dtype", exp.compute_dtype,
    ]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m r2d2dpg_torch.fleet.actor", description=__doc__
    )
    p.add_argument("--config", required=True, choices=sorted(CONFIGS))
    p.add_argument("--connect", required=True, help="ingest server address")
    p.add_argument("--actor-id", type=int, required=True)
    p.add_argument("--num-actors", type=int, required=True)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; the spawner passes cpu)")
    p.add_argument("--phases", type=int, default=None,
                   help="stop after this many collect phases (default: "
                   "stream until the server disconnects)")
    # Structural/exploration overrides: must match the learner's so the
    # published param trees fit the actor's nets (train.py forwards them).
    p.add_argument("--num-envs", type=int, default=None)
    p.add_argument("--n-step", type=int, default=None)
    p.add_argument("--twin-critic", type=int, default=None, choices=[0, 1])
    p.add_argument("--sigma-max", type=float, default=None)
    p.add_argument("--ladder-alpha", type=float, default=None)
    p.add_argument("--compute-dtype", default=None,
                   choices=["float32", "bfloat16"])
    # The wire lane: must mirror the learner's --fleet-wire/--fleet-compress.
    p.add_argument("--wire", default="f32", choices=list(wire.ENCODINGS),
                   help="payload precision on the wire (bf16: observations/"
                   "carries/params downcast; rewards/priorities stay f32)")
    p.add_argument("--compress", default="none",
                   choices=list(wire.COMPRESSIONS),
                   help="frame compression (zstd only where the zstandard "
                   "module is installed)")
    p.add_argument("--max-frame-bytes", type=int, default=MAX_FRAME_BYTES,
                   help="frame ceiling; must mirror the learner's")
    p.add_argument("--flight-path", default=None,
                   help="dump this actor's flight ring here on exit")
    p.add_argument("--telem-every", type=float, default=0.0,
                   help="seconds between TELEM registry-snapshot pushes to "
                   "the learner's ingest (0 = off; --obs-fleet spawns 1.0)")
    p.add_argument("--trace-sample", type=float, default=0.0,
                   help="experience-path trace sampling rate in [0, 1] "
                   "(0 = off: no trace sidecar, byte-identical wire)")
    p.add_argument("--read-deadline", type=float, default=READ_DEADLINE_S,
                   help="seconds a blocking wire read may wait before the "
                   "PING-then-reap liveness protocol runs; mirrors the "
                   "learner's --fleet-heartbeat")
    p.add_argument("--fleet-token", default=None,
                   help="shared HELLO-authentication secret; defaults to "
                   "$R2D2DPG_FLEET_TOKEN (the spawner passes the secret "
                   "via the environment so it never shows in ps)")
    p.add_argument("--shard-direct", type=int, default=0, choices=[0, 1],
                   help="1: dial the learner-advertised replay shard and "
                   "ship SEQS to it directly (the control connection "
                   "carries params and accounting only); falls back "
                   "loudly to the learner-forwarded path on any data-leg "
                   "failure")
    p.add_argument("--chaos-spec", default=None,
                   help="seeded chaos schedule (fleet/chaos.py grammar); "
                   "this actor fires the actor-side faults that target "
                   "its id (the learner's engine fires the rest)")
    return p.parse_args(argv)


def _apply_overrides(exp: ExperimentConfig, args) -> ExperimentConfig:
    t = {
        k: getattr(args, k)
        for k in ("num_envs", "sigma_max", "ladder_alpha", "seed")
        if getattr(args, k) is not None
    }
    if t:
        exp = dataclasses.replace(
            exp, trainer=dataclasses.replace(exp.trainer, **t)
        )
    a = {}
    if args.n_step is not None:
        a["n_step"] = args.n_step
    if args.twin_critic is not None:
        a["twin_critic"] = bool(args.twin_critic)
    if a:
        exp = dataclasses.replace(
            exp, agent=dataclasses.replace(exp.agent, **a)
        )
    if args.compute_dtype is not None:
        exp = dataclasses.replace(exp, compute_dtype=args.compute_dtype)
    return exp


def main(argv=None) -> None:
    args = parse_args(argv)
    set_flight_identity(actor=args.actor_id)
    if args.flight_path:
        from r2d2dpg_torch.obs import get_flight_recorder

        flight_path = args.flight_path
        if os.path.exists(flight_path):
            # A predecessor incarnation (supervised restart) dumped here:
            # keep its evidence and dump beside it.
            root, ext = os.path.splitext(flight_path)
            flight_path = f"{root}.pid{os.getpid()}{ext}"
        get_flight_recorder().install(flight_path)
        # The supervisor's orderly teardown is a SIGTERM, whose default
        # disposition skips atexit and with it the flight dump.
        signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    exp = _apply_overrides(get_config(args.config), args)
    try:
        wire_config = wire.WireConfig(
            encoding=args.wire, compress=args.compress
        ).validate()
    except ValueError as e:
        raise SystemExit(f"fleet actor {args.actor_id}: --compress: {e}")
    if not 0.0 <= args.trace_sample <= 1.0:
        raise SystemExit(
            f"fleet actor {args.actor_id}: --trace-sample must be in [0, 1]"
        )
    auth_token = args.fleet_token
    if auth_token is None:
        auth_token = os.environ.get("R2D2DPG_FLEET_TOKEN") or None
    try:
        actor = FleetActor(
            exp,
            actor_id=args.actor_id,
            num_actors=args.num_actors,
            address=args.connect,
            seed=args.seed,
            wire_config=wire_config,
            max_frame_bytes=args.max_frame_bytes,
            telem_every=args.telem_every,
            trace_sample=args.trace_sample,
            read_deadline_s=args.read_deadline,
            auth_token=auth_token,
            shard_direct=bool(args.shard_direct),
            chaos_spec=args.chaos_spec,
            device=args.device,
        )
    except ValueError as e:
        # A malformed --chaos-spec: refused at startup, not crash-looped.
        raise SystemExit(f"fleet actor {args.actor_id}: {e}")
    # SIGUSR1 asks for an orderly drain: finish the phase, BYE, exit 0.
    signal.signal(signal.SIGUSR1, lambda *_: actor.request_drain())
    flight_event("actor_start", phase=0, address=args.connect)
    try:
        actor.run(max_phases=args.phases)
    except _OrderlyShutdown:
        flight_event("actor_disconnect", phase=actor._phase)
    except (_WireRefused, _AuthRefused) as e:
        # Deterministic misconfiguration: exit with the dedicated code so
        # the supervisor gives this slot up instead of restarting it.
        err = f"{type(e).__name__}: {e}"
        auth = isinstance(e, _AuthRefused)
        flight_event(
            "actor_auth_refused" if auth else "actor_wire_refused",
            phase=actor._phase,
            error=err,
        )
        print(f"fleet actor {args.actor_id}: {err}", file=sys.stderr, flush=True)
        raise SystemExit(EXIT_AUTH_REFUSED if auth else EXIT_WIRE_REFUSED)
    except (FrameError, OSError) as e:
        # Refused connect, CRC violation, torn stream: a CRASH; exit
        # nonzero so the supervisor restarts us.
        err = f"{type(e).__name__}: {e}"
        flight_event("actor_conn_lost", phase=actor._phase, error=err)
        raise SystemExit(
            f"fleet actor {args.actor_id}: connection lost at phase "
            f"{actor._phase}: {err}"
        )
    flight_event("actor_exit", phase=actor._phase, sheds=actor._sheds)


if __name__ == "__main__":
    main()
