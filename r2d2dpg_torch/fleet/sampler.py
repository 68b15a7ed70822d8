"""In-network experience sampling: sharded replay, learner-pulled batches.

Port of ``r2d2dpg_tpu/fleet/sampler.py`` (In-Network Experience Sampling,
PAPERS.md 2110.13506; Ape-X distributed replay, 1803.00933)::

    actor 0 -- SEQS --> handler --> [shard 0]  priority structure + ring
    actor 1 -- SEQS --> handler --> [shard 1]      (replay/sharded.py)
    actor i -- SEQS --> handler --> [shard h(i) mod N]
                                        ^ |
                     SAMPLE_REQ {quota} -+ | BATCH {seqs, slots/gens,
                     PRIO {slot, gen, p} <-+        probs, sum p^a}
                                      sampler learner:
                                      quotas ~ sum p^a -> K*B draws ->
                                      K learner steps -> TD write-back

- **Adds are concurrent**: each ingest handler writes straight into its
  actor's shard (``shard_for_actor``) under that shard's lock.
- **The learner pulls**: each train phase draws per-shard quotas from a
  multinomial over the shards' ``sum p^alpha``, samples within each shard
  proportionally, and learns on the ``[K, B]`` batch with importance
  weights from the combined two-level probabilities (the central
  proportional distribution exactly).
- **Priority write-back** rides PRIO frames keyed ``(shard, slot,
  generation)``; an evicted slot ignores the stale verdict.
- **Backpressure is ring eviction**: shards never shed, actor acks are
  always ``OK``.

Every sample and write-back crosses the real ``SAMPLE_REQ``/``BATCH``/
``PRIO`` codecs (``fleet/wire.py``), through an in-process loopback
(``--replay-shards N``) or over sockets to standalone shard processes
(``fleet/shard.py``, ``--shard-procs N``): the byte count is what crosses
the sampling boundary either way.

What the card needs:

- **No device arena on the hot path.**  The trainer's arena is unused
  (the train CLI shrinks it to ``max(num_envs, batch_size)`` slots) and
  the priority scatter kernel is never launched: priorities go back to
  the host-side shards.
- **One copy in, one copy out, per phase.**  The pulled ``[K*B, ...]``
  numpy batch (permuted on the host) and its float32 combined
  probabilities cross to the device in ONE host-to-device copy
  (``ingest.pack_host``, the ``put_staged`` pattern) on the learner's
  thread and current stream, as views ``[K, B, ...]``; the K learner
  steps' TD priorities ``[K, B]`` come back in ONE synchronous copy after
  the K-th update (the ``sampler/prio_fetch`` range, timed per phase).
- **Threads.**  Ingest handlers, pullers and the prefetch thread run
  numpy only and make no CUDA call; only the learner's thread runs the
  nets.
- **Types at the boundary.**  ``combine_probs`` is float64; the learner
  casts it to float32 on the host, before the copy, as the JAX learner's
  placement does.  Slots and generations stay int64 on the host.

``_learn`` is a plain loop of K ``agent.learner_step`` calls (the JAX
learner's scan), each with IS weights from ``importance_weights`` and
``anneal_beta``; target-policy smoothing normals come from the learner's
``Draws``.  The shard draws, quotas and permutation use numpy's
``default_rng(seed)``, as in the JAX package, so they are bitwise equal to
JAX's for the same adds and seed.

``--replay-shards 1 --actors 0`` never builds this class: the phase-locked
``Trainer.run`` runs untouched.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from r2d2dpg_torch.fleet import transport, wire
from r2d2dpg_torch.fleet.ingest import (
    FleetConfig,
    IngestServer,
    pack_host,
    prune_fleet_counters,
    save_fleet_counters,
    snapshot_params,
    staged_template,
    unpack_buffer,
)
from r2d2dpg_torch.obs import flight_event, get_device_monitor, get_registry
from r2d2dpg_torch.obs.device import count_flops
from r2d2dpg_torch.obs import trace as obs_trace
from r2d2dpg_torch.obs.quality import (
    PROVENANCE_ABSENT,
    get_quality_plane,
    policy_lags,
    quality_stats_columns,
    replay_ages,
)
from r2d2dpg_torch.ops import anneal_beta, importance_weights
from r2d2dpg_torch.parallel.control import LEARN, STOP, control_plane
from r2d2dpg_torch.replay.arena import SequenceBatch, StagedSequences
from r2d2dpg_torch.replay.sharded import (
    ReplayShard,
    actor_code,
    combine_probs,
    shard_instruments,
    shard_quotas,
)
from r2d2dpg_torch.training.pipeline import merge_state, split_state
from r2d2dpg_torch.training.trainer import Trainer, TrainerState
from r2d2dpg_torch.tree import tree_map
from r2d2dpg_torch.utils.metrics import PercentileWindow
from r2d2dpg_torch.utils.profiling import annotate


def _resp_provenance(resp: Dict[str, Any]) -> tuple:
    """(behavior, collect, actors) of one BATCH response, sentinel-filled
    when the frame carried no provenance."""
    n = int(np.shape(resp["slots"])[0])

    def get(k: str) -> np.ndarray:
        v = resp.get(k)
        if v is None:
            return np.full((n,), PROVENANCE_ABSENT, np.int64)
        return np.asarray(v, np.int64)

    return (get("behavior"), get("collect"), get("actors"))


def shard_for_actor(actor_id: Any, num_shards: int) -> int:
    """Consistent actor -> shard routing: a pure function of the actor id,
    so a restarted actor lands on the same shard.  Integer ids route by
    modulo, any other id by crc32."""
    s = str(actor_id)
    if s.lstrip("-").isdigit():
        return int(s) % max(num_shards, 1)
    return zlib.crc32(s.encode()) % max(num_shards, 1)


class ShardSet:
    """N in-learner replay shards, the actor routing and the accounting bank.

    Written by the ingest handler threads (``add`` routes each actor's
    SEQS batch into its shard under that shard's lock), read by the
    sampler.  The episode/step deltas bank here and the learner pops them
    once per phase, so the sums stay monotone whatever the sampler does."""

    def __init__(
        self,
        num_shards: int,
        shard_capacity: int,
        *,
        alpha: float = 0.6,
        prioritized: bool = True,
    ):
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        psum, occ, evict = shard_instruments()
        qplane = get_quality_plane()
        self.shards = [
            ReplayShard(
                shard_capacity,
                alpha=alpha,
                prioritized=prioritized,
                shard_id=i,
                evict_cb=evict.labels(shard=str(i)).inc,
                evict_unsampled_cb=(
                    lambda evicted, unsampled, _i=i: qplane.note_evictions(
                        _i, evicted, unsampled)
                ),
            )
            for i in range(num_shards)
        ]
        self._stats_lock = threading.Lock()
        self._stats = {"env_steps_delta": 0.0, "ep_return_sum": 0.0, "ep_count": 0.0}
        for i, s in enumerate(self.shards):
            psum.labels(shard=str(i)).set_fn(s.priority_sum)
            occ.labels(shard=str(i)).set_fn(s.occupancy)

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    def route(self, actor_id: Any) -> int:
        return shard_for_actor(actor_id, len(self.shards))

    def add(self, shard_id: int, msg: Dict[str, Any]) -> int:
        """One SEQS message into its shard (handler-thread side); never
        sheds.  ``msg["actor_id"]`` is the HELLO-authenticated identity
        the ingest handler stamped."""
        staged: StagedSequences = msg["staged"]
        actor = msg.get("actor_id")
        n = self.shards[shard_id].add(
            staged.seq,
            staged.priorities,
            behavior=staged.behavior_version,
            collect=staged.collect_id,
            actor=None if actor is None else actor_code(actor),
        )
        self.bank_stats(msg)
        return n

    def bank_stats(self, msg: Dict[str, Any]) -> None:
        """Bank one message's accounting deltas."""
        with self._stats_lock:
            for k in self._stats:
                self._stats[k] += float(msg.get(k, 0.0))

    def pop_stats(self) -> Dict[str, float]:
        with self._stats_lock:
            out = dict(self._stats)
            for k in self._stats:
                self._stats[k] = 0.0
        return out

    def occupancy_total(self) -> int:
        return sum(s.occupancy() for s in self.shards)

    def scaled_sums(self) -> np.ndarray:
        return np.asarray([s.scaled_sum() for s in self.shards], np.float64)

    def evictions_total(self) -> int:
        return sum(s.evictions_total for s in self.shards)


class _PrefetchPull:
    """One background pull (``--shard-prefetch 1``): phase p+1's draw,
    encode and transit overlap phase p's learner steps.  Exactly one pull
    is in flight, so the numpy draw stream stays sequential.  Numpy only;
    daemon, so a pull stuck on a dead tier never pins process exit."""

    def __init__(self, fn: Callable[[], Any]):
        self._result: Any = None
        self._error: Optional[BaseException] = None
        self._done = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(fn,), name="sampler-prefetch", daemon=True)
        self._thread.start()

    def _run(self, fn) -> None:
        try:
            self._result = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised at result()
            self._error = e
        finally:
            self._done.set()

    def result(self) -> Any:
        self._done.wait()
        if self._error is not None:
            raise self._error
        return self._result


def pull_learn(t: Trainer, train, seqs: SequenceBatch, probs: torch.Tensor,
               size: int, draws):
    """K importance-weighted learner steps on a pulled batch.

    ``seqs`` leaves are ``[K, B, ...]`` (this rank's ``B/D`` rows on a
    mesh) and ``probs`` the combined two-level probabilities ``[K, B]``
    (float32), on the learner's device; ``size`` is the fleet-wide
    occupancy (the N of the IS correction).  Returns ``(train, priorities
    [K, B/D], metrics)``, the metrics the mean over the K steps.  No arena
    scatter: the priorities go back to the shards on the host."""
    cfg = t.config
    acfg = t.agent.config
    prios, steps = [], []
    for k in range(cfg.learner_steps):
        batch = tree_map(lambda x: x[k], seqs)
        if cfg.prioritized:
            beta = anneal_beta(train.step, beta0=cfg.beta0, steps=cfg.beta_steps)
            w = importance_weights(probs[k], size, beta=beta)
        else:
            w = torch.ones(cfg.batch_size, device=probs.device)
        normal = None
        if acfg.target_policy_sigma > 0:
            normal = draws.normal(
                (acfg.unroll + acfg.n_step, cfg.batch_size, batch.action.shape[-1]))
        # The rows arrive as this rank's share (_put_staged(axis=1));
        # the weights and the normal are the whole batch's.
        batch, w, normal = t._reshard_batch(batch, w, normal)
        train, p, m = t.agent.learner_step(train, batch, w, normal)
        prios.append(p)
        steps.append(m)
    metrics = {k: torch.stack([m[k] for m in steps]).mean() for k in steps[0]}
    return train, torch.stack(prios), t._pmean(metrics)


def gather_priorities(t: Trainer, prios: torch.Tensor) -> Optional[torch.Tensor]:
    """The ``[K, B]`` TD priorities in global batch order on rank 0 (each
    rank's ``[K, B/D]`` columns, gathered in rank order); None on the other
    ranks; ``prios`` itself off a mesh."""
    mesh = getattr(t, "mesh", None)
    if mesh is None:
        return prios
    parts = mesh.gather(prios)
    return None if parts is None else torch.cat(parts, dim=1)


def pulled_template(window, n: int) -> Dict[str, Any]:
    """The host layout of a pulled batch of ``n`` sequences and its
    probabilities (``ingest.staged_template``'s rows)."""
    return {"seq": staged_template(window, n, False, False).seq,
            "probs": np.empty(n, np.float32)}


def _place_views(t: Trainer, dev: Dict[str, Any]):
    """``[K, B, ...]`` views of a placed ``[K*B, ...]`` pulled batch, then
    the trainer's placement hook on the batch axis: the dp learner keeps
    this rank's B/D rows (identity for one device).  The probabilities
    stay whole: the IS weights normalize over the batch."""
    kb = (t.config.learner_steps, t.config.batch_size)
    seqs = tree_map(lambda x: x.view(kb + tuple(x.shape[1:])), dev["seq"])
    return t._put_staged(seqs, axis=1), dev["probs"].view(kb)


def follow_pull(trainer: Trainer, state: Optional[TrainerState] = None) -> TrainerState:
    """A rank > 0's side of ``SamplerLearner.run`` on a mesh trainer: each
    control record, then the pulled batch received into a fresh device
    buffer, its ``B/D`` rows learned as rank 0 learns them, and the TD
    priorities gathered to rank 0, until STOP (an ERROR raises)."""
    t = trainer
    control = control_plane(t)
    control.open()
    state = t.init() if state is None else state
    cstate, lstate = split_state(state)
    train, drained = lstate.train, 0
    while True:
        rec = control.recv()
        drained = rec.drained
        if rec.op == STOP:
            break
        buf = control.recv_payload(rec.nbytes)
        seqs, probs = _place_views(t, unpack_buffer(buf, pulled_template(
            cstate.window, rec.width)))
        train, prios, _ = pull_learn(t, train, seqs, probs, rec.size, lstate.draws)
        gather_priorities(t, prios)
    lstate = dataclasses.replace(lstate, train=train)
    return dataclasses.replace(merge_state(state, cstate, lstate),
                               phase_idx=cstate.phase_idx + drained)


class SamplerLearner:
    """The learner side of in-network sampling (``--replay-shards N``).

    ``FleetLearner``'s lifecycle (start/run/close, counters, checkpoint
    sidecar, param publication) with a PULL loop in place of the drain:
    no staging queue and no device arena on the hot path.  Each train
    phase assembles K batches of ``batch_size`` from the shards through
    the SAMPLE_REQ/BATCH codecs, runs K learner steps on the card and
    writes the TD priorities back through PRIO frames.  The learner runs
    at its own pace (the Ape-X relation).

    ``shard_set`` swaps the in-learner loopback ``ShardSet`` for the
    standalone tier's ``RemoteShardSet`` (``fleet/shard.py``)."""

    def __init__(
        self,
        trainer: Trainer,
        config: FleetConfig,
        *,
        num_shards: int,
        total_capacity: Optional[int] = None,
        shard_set=None,
    ):
        if getattr(trainer, "axis", None) is not None:
            raise ValueError(
                "SamplerLearner needs a host-visible learn boundary; "
                "shard_map trainers fuse whole phases; use the base Trainer")
        if config.num_actors < 1:
            raise ValueError(
                "SamplerLearner requires num_actors >= 1 (replay shards "
                "are fed by actor SEQS traffic)")
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        if config.drain_coalesce != 1:
            raise ValueError(
                "--drain-coalesce shapes the central drain the sampler "
                "path replaces; it does not compose with --replay-shards")
        cap = int(total_capacity) if total_capacity is not None else trainer.config.capacity
        if cap % num_shards:
            raise ValueError(
                f"replay capacity {cap} not divisible by {num_shards} "
                f"shards (each shard owns an equal slice)")
        if config.shard_pullers < 0:
            raise ValueError("shard_pullers must be >= 0")
        config.wire.validate()
        self.trainer = trainer
        self.config = config
        self.num_shards = num_shards
        self._remote = shard_set is not None
        if self._remote:
            if shard_set.num_shards != num_shards:
                raise ValueError(
                    f"shard_set has {shard_set.num_shards} shards, "
                    f"expected {num_shards}")
            self.shards = shard_set
        else:
            self.shards = ShardSet(
                num_shards, cap // num_shards,
                alpha=trainer.config.priority_alpha,
                prioritized=trainer.config.prioritized)
        # N pullers over M shards, one in-flight SAMPLE_REQ per live shard
        # per quota round; 0 = min(shards, 8); 1 = the serial loop.
        self._pullers = (int(config.shard_pullers) if config.shard_pullers > 0
                         else min(num_shards, 8))
        # The ingest server routes SEQS straight into the shards; the
        # staging queue exists only structurally (nothing enqueues).
        self.queue: "queue.Queue" = queue.Queue(maxsize=config.queue_depth)
        # The direct data plane needs dialable shards: in-learner shards
        # have no address, so their actors keep forwarding.
        self._direct = bool(config.shard_direct) and self._remote
        self.server = IngestServer(
            self.queue,
            address=config.address,
            shed_after_s=config.shed_after_s,
            wire_config=config.wire,
            read_deadline_s=config.heartbeat_s,
            auth_token=config.auth_token,
            shards=self.shards,
            expected_actors=config.num_actors,
            shard_assignment_fn=(
                self.shards.assignment_for if self._direct else None),
        )
        # Loopback codecs, one packer/unpacker pair per direction (the
        # sampler loop is their only caller).
        self._req_packer = wire.TreePacker(config.wire)
        self._req_unpacker = wire.TreeUnpacker()
        self._batch_packer = wire.TreePacker(config.wire)
        self._batch_unpacker = wire.TreeUnpacker()
        self._req_id = 0
        self._phase_stall_s = 0.0  # the pull's dead-tier wait, per phase
        self.sample_bytes_total = 0  # SAMPLE_REQ + BATCH + PRIO, headers in
        self.trained_seqs_total = 0
        self._quality_ctx = (0, 0)  # (published version, drained phases)
        reg = get_registry()
        self.sampler_wait = reg.histogram(
            "r2d2dpg_sampler_wait_seconds",
            "seconds the pull loop stalled waiting for a live non-empty "
            "shard, one sample per phase (zeros included; the cold-start "
            "absorb is r2d2dpg_sampler_absorb_seconds)",
        )
        self.sampler_absorb = reg.histogram(
            "r2d2dpg_sampler_absorb_seconds",
            "absorb-to-min_replay wait, one sample per incarnation "
            "(cold start and --resume re-entry)",
        )
        self.sample_assemble = reg.histogram(
            "r2d2dpg_sampler_sample_seconds",
            "one phase's SAMPLE_REQ -> stacked-batch assembly (pack, "
            "shard draws, decode, stack)",
        )
        self.puller_wait = reg.histogram(
            "r2d2dpg_sampler_puller_wait_seconds",
            "one puller's SAMPLE_REQ -> BATCH exchange wall time, one "
            "sample per per-shard draw",
        )
        self._obs_trained = reg.counter(
            "r2d2dpg_sampler_trained_seqs_total",
            "sequences pulled across the sampling boundary into training",
        )
        self._obs_bytes = reg.counter(
            "r2d2dpg_sampler_bytes_total",
            "bytes crossing the sampling boundary (SAMPLE_REQ + BATCH + "
            "PRIO frames, headers included)",
        )
        if self._remote:
            self.shards.bind_sample_bytes(self._obs_bytes.inc)
        self._stats: Dict[str, float] = {}
        self._counters: Dict[str, float] = {}

    # ------------------------------------------------------------- lifecycle
    def start(self) -> str:
        self.server.start()
        return self.server.connect_address

    def close(self) -> None:
        self.server.stop()

    def stats(self) -> Dict[str, float]:
        return dict(self._stats)

    def counters(self) -> Dict[str, float]:
        return dict(self._counters)

    # ---------------------------------------------------------------- learn
    def _learn(self, train, seqs: SequenceBatch, probs: torch.Tensor,
               size: int, draws):
        """K importance-weighted learner steps on a pulled batch
        (``pull_learn``)."""
        return pull_learn(self.trainer, train, seqs, probs, size, draws)

    def _place(self, seq_np: SequenceBatch, probs_np: np.ndarray):
        """The pulled batch and its combined probabilities on the learner's
        device in one host-to-device copy, as ``[K, B, ...]`` views."""
        return self._pack(seq_np, probs_np)[:2]

    def _pack(self, seq_np: SequenceBatch, probs_np: np.ndarray, window=None):
        """``_place`` and the device byte buffer of the copy (what rank 0
        broadcasts); with ``window``, the layout is checked against the
        template the followers derive from it."""
        t = self.trainer
        n = t.config.learner_steps * t.config.batch_size
        dev, buf = pack_host(
            {"seq": seq_np, "probs": probs_np.astype(np.float32)}, t.device,
            None if window is None else pulled_template(window, n))
        return (*_place_views(t, dev), buf)

    # ------------------------------------------------------- sample assembly
    def _roundtrip(self, unpacker, parts) -> Any:
        """One loopback frame: count its wire bytes (header included) and
        decode it through the real unpacker."""
        payload = b"".join(bytes(p) for p in parts)
        n = transport.HEADER_BYTES + len(payload)
        self.sample_bytes_total += n
        self._obs_bytes.inc(n)
        return unpacker.unpack(payload)

    def _fold_quality(self, behavior, collect, actors, probs, occupancy) -> None:
        """Quality-plane fold at the batch-assembly site, on host numpy.
        Beta is the anneal's value at ``phase * K`` learner steps."""
        plane = get_quality_plane()
        version, phase = self._quality_ctx
        if behavior is not None:
            plane.observe_lags(policy_lags(version, behavior))
        if collect is not None:
            plane.observe_ages(replay_ages(phase, collect))
        cfg = self.trainer.config
        if cfg.prioritized:
            step = phase * cfg.learner_steps
            frac = min(step / max(cfg.beta_steps, 1), 1.0)
            beta = cfg.beta0 + (1.0 - cfg.beta0) * frac
        else:
            beta = 0.0
        plane.observe_probs(probs, occupancy, beta)
        if actors is not None:
            a = np.asarray(actors, np.int64).ravel()
            a = a[a != PROVENANCE_ABSENT]
            if a.size:
                codes, counts = np.unique(a, return_counts=True)
                for c, n in zip(codes, counts):
                    plane.note_trained(str(int(c)), int(n))

    def _pull_phase_batches(self, n_draws: int, rng: np.random.Generator, tr=None):
        """One phase's two-level pull: quotas ~ advertised sum p^alpha, one
        SAMPLE_REQ/BATCH exchange per non-empty shard.

        Returns ``(seq [n, ...], probs [n] float64, handles,
        occupancy_total)`` with the draws PERMUTED (seeded), so update k
        does not correlate with shard identity.  ``tr`` (a sampled
        phase's trace stamp) rides the remote path's SAMPLE_REQ sidecar.
        ``self._phase_stall_s`` receives the pull's dead-tier wait."""
        self._phase_stall_s = 0.0
        if self._remote:
            return self._pull_phase_batches_remote(n_draws, rng, tr)
        sums = self.shards.scaled_sums()
        quotas = shard_quotas(sums, n_draws, rng)
        total = float(sums.sum())
        seqs: List[SequenceBatch] = []
        probs: List[np.ndarray] = []
        handles: List[tuple] = []  # (shard, slots, gens) per response
        prov: List[tuple] = []
        for shard_id, quota in enumerate(quotas):
            if quota == 0:
                continue
            self._req_id += 1
            req = wire.unpack_sample_req(self._roundtrip(
                self._req_unpacker,
                wire.pack_sample_req(self._req_packer, req_id=self._req_id,
                                     shard=shard_id, quota=int(quota))))
            shard = self.shards.shards[req["shard"]]
            s = shard.sample(req["quota"], rng)
            resp = wire.unpack_shard_batch(self._roundtrip(
                self._batch_unpacker,
                wire.pack_shard_batch(
                    self._batch_packer,
                    req_id=req["req_id"],
                    shard=req["shard"],
                    staged=StagedSequences(seq=s.seq, priorities=None),
                    slots=s.slots,
                    gens=s.gens,
                    probs=s.probs,
                    priority_sum=shard.scaled_sum(),
                    occupancy=shard.occupancy(),
                    behavior=s.behavior,
                    collect=s.collect,
                    actors=s.actors,
                )))
            seqs.append(resp["staged"].seq)
            probs.append(combine_probs(resp["probs"], float(sums[shard_id]), total))
            handles.append((req["shard"], resp["slots"], resp["gens"]))
            prov.append(_resp_provenance(resp))
        seq = tree_map(lambda *xs: np.concatenate(xs, axis=0), *seqs)
        prob = np.concatenate(probs)
        shard_of = np.concatenate([np.full(len(h[1]), h[0], np.int64) for h in handles])
        slots = np.concatenate([h[1] for h in handles])
        gens = np.concatenate([h[2] for h in handles])
        perm = rng.permutation(n_draws)
        seq = tree_map(lambda x: x[perm], seq)
        occ_total = self.shards.occupancy_total()
        self._fold_quality(*(np.concatenate([p[i] for p in prov]) for i in range(3)),
                           prob, occ_total)
        return seq, prob[perm], (shard_of[perm], slots[perm], gens[perm]), occ_total

    def _pull_phase_batches_remote(self, n_draws: int, rng: np.random.Generator,
                                   tr=None):
        """The ``--shard-procs`` pull: the same math over sockets.  A shard
        whose exchange fails is marked dead and its quota redrawn over the
        survivors within this phase; a tier with no live non-empty shard
        is waited out up to ``idle_timeout_s``.  Handles carry each
        batch's shard epoch for the write-back fence."""
        from r2d2dpg_torch.fleet.shard import ShardUnavailableError

        shards = self.shards
        shards.maybe_rejoin()
        seqs: List[SequenceBatch] = []
        probs: List[np.ndarray] = []
        shard_of, slots, gens, epochs = [], [], [], []
        prov: List[tuple] = []
        remaining = int(n_draws)
        deadline = time.monotonic() + self.config.idle_timeout_s
        stall_t0: Optional[float] = None
        while remaining > 0:
            sums = shards.scaled_sums()
            total = float(sums.sum())
            if total <= 0.0:
                # Every shard dead or freshly rejoined and empty: wait for
                # the supervisor's restart; never fabricate draws.
                if stall_t0 is None:
                    stall_t0 = time.monotonic()
                if time.monotonic() >= deadline:
                    raise RuntimeError(
                        "sampler starved: no live non-empty replay shard to "
                        "draw from (shard tier down past "
                        f"{self.config.idle_timeout_s:.0f}s; check "
                        "flight.jsonl for shard_dead/shard_crash events)")
                shards.maybe_rejoin()
                time.sleep(0.1)
                continue
            if stall_t0 is not None:
                self._phase_stall_s += time.monotonic() - stall_t0
                stall_t0 = None
            quotas = shard_quotas(sums, remaining, rng)
            remaining = 0
            # Req ids in shard-id order before any exchange, results in
            # shard-id order after the join: arrival order reaches no draw.
            jobs: List[tuple] = []  # (shard_id, quota, req_id, req_tr)
            for shard_id, quota in enumerate(quotas):
                if quota == 0:
                    continue
                self._req_id += 1
                req_tr = None
                if tr is not None:
                    req_tr = obs_trace.TraceStamp(trace_id=tr.trace_id,
                                                  t_collect_start=time.time())
                jobs.append((shard_id, int(quota), self._req_id, req_tr))
            for (shard_id, quota, _, _), outcome in zip(
                    jobs, self._exchange_jobs(shards, jobs)):
                if isinstance(outcome, ShardUnavailableError):
                    # The dead shard's draws go back into the pool; the next
                    # quota round sees its weight zeroed.
                    shards._mark_dead(shard_id, str(outcome))
                    flight_event("shard_draws_redistributed", shard=shard_id,
                                 redistributed_draws=int(quota))
                    remaining += int(quota)
                    continue
                resp = outcome
                if resp is None:
                    # Live but empty (a stale weight met a restarted ring):
                    # its ack zeroed the weight; redraw elsewhere.
                    remaining += int(quota)
                    continue
                seqs.append(resp["staged"].seq)
                probs.append(combine_probs(resp["probs"], float(sums[shard_id]), total))
                n_got = int(resp["slots"].shape[0])
                shard_of.append(np.full(n_got, shard_id, np.int64))
                slots.append(np.asarray(resp["slots"], np.int64))
                gens.append(np.asarray(resp["gens"], np.int64))
                epochs.append(np.full(n_got, int(resp["epoch"]), np.int64))
                prov.append(_resp_provenance(resp))
        seq = tree_map(lambda *xs: np.concatenate(xs, axis=0), *seqs)
        perm = rng.permutation(n_draws)
        seq = tree_map(lambda x: x[perm], seq)
        prob = np.concatenate(probs)
        occ_total = self.shards.occupancy_total()
        self._fold_quality(*(np.concatenate([p[i] for p in prov]) for i in range(3)),
                           prob, occ_total)
        return (seq, prob[perm],
                (np.concatenate(shard_of)[perm], np.concatenate(slots)[perm],
                 np.concatenate(gens)[perm], np.concatenate(epochs)[perm]),
                occ_total)

    def _exchange_jobs(self, shards, jobs: List[tuple]) -> List[Any]:
        """One quota round's SAMPLE_REQ/BATCH exchanges, results in job
        order whatever the arrival order.  ``--shard-pullers 1`` runs them
        inline; otherwise up to ``self._pullers`` are in flight, one per
        shard.  A ``ShardUnavailableError`` is an outcome; anything else
        re-raises on the caller's thread."""
        from r2d2dpg_torch.fleet.shard import ShardUnavailableError

        def one(shard_id: int, quota: int, req_id: int, req_tr) -> Any:
            t0 = time.monotonic()
            try:
                return shards.shards[shard_id].sample(quota, req_id, trace=req_tr)
            except ShardUnavailableError as e:
                return e
            finally:
                self.puller_wait.add(time.monotonic() - t0)

        if self._pullers <= 1 or len(jobs) <= 1:
            return [one(*job) for job in jobs]
        results: List[Any] = [None] * len(jobs)
        errors: List[BaseException] = []
        sem = threading.BoundedSemaphore(self._pullers)

        def work(i: int, job: tuple) -> None:
            with sem:
                try:
                    results[i] = one(*job)
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    errors.append(e)

        threads = [threading.Thread(target=work, args=(i, job),
                                    name=f"sampler-puller-{job[0]}", daemon=True)
                   for i, job in enumerate(jobs)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        return results

    def _write_back_remote(self, handles, prios: np.ndarray) -> None:
        """TD write-back to standalone shards, one PRIO frame per (shard,
        epoch): a dead shard drops its verdict, and handles of a previous
        incarnation are fenced here before a byte crosses (the shard's own
        epoch check is the backstop)."""
        from r2d2dpg_torch.fleet.shard import ShardUnavailableError

        shard_of, slots, gens, epochs = handles
        prios = np.asarray(prios, np.float32).reshape(-1)
        for shard_id in np.unique(shard_of):
            sh = self.shards.shards[int(shard_id)]
            m_shard = shard_of == shard_id
            for ep in np.unique(epochs[m_shard]):
                m = m_shard & (epochs == ep)
                if not sh.alive:
                    flight_event("prio_dropped_shard_dead", shard=int(shard_id),
                                 entries=int(m.sum()))
                    continue
                if sh.epoch != int(ep):
                    flight_event("stale_epoch_prio_dropped", shard=int(shard_id),
                                 got_epoch=int(ep), epoch=sh.epoch,
                                 entries=int(m.sum()))
                    continue
                c_slots, c_gens, c_prios = wire.coalesce_prio_update(
                    slots[m], gens[m], prios[m])
                try:
                    sh.write_back(c_slots, c_gens, c_prios, epoch=int(ep))
                except ShardUnavailableError as e:
                    self.shards._mark_dead(int(shard_id), str(e))
                    flight_event("prio_dropped_shard_dead", shard=int(shard_id),
                                 entries=int(m.sum()))

    def _write_back(self, handles, prios: np.ndarray) -> None:
        """TD write-back through PRIO frames, one per shard, each (slot,
        generation) key once (last write wins); stale generations are
        ignored shard-side."""
        if self._remote:
            return self._write_back_remote(handles, prios)
        shard_of, slots, gens = handles
        prios = np.asarray(prios, np.float32).reshape(-1)
        for shard_id in np.unique(shard_of):
            m = shard_of == shard_id
            c_slots, c_gens, c_prios = wire.coalesce_prio_update(
                slots[m], gens[m], prios[m])
            upd = wire.unpack_prio_update(self._roundtrip(
                self._req_unpacker,
                wire.pack_prio_update(self._req_packer, shard=int(shard_id),
                                      slots=c_slots, gens=c_gens,
                                      priorities=c_prios)))
            if upd["shard"] >= self.num_shards:
                raise wire.WireFormatError(
                    f"PRIO shard {upd['shard']} outside fleet of {self.num_shards}")
            self.shards.shards[upd["shard"]].update_priorities(
                upd["slots"], upd["gens"], upd["priorities"])

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
        trace_sample: float = 0.0,
    ) -> TrainerState:
        """Wait for ``min_replay`` resident sequences across the shards,
        then run ``num_train_phases`` pull-learn phases (K*B two-level
        draws, K learner steps, PRIO write-back each).  The checkpoint,
        resume and counter contract is ``FleetLearner.run``'s; the shards
        are never checkpointed (a resumed learner refills them from live
        actors).  ``health_fn()`` runs while the absorb waits and may
        raise to abort the run; ``phase_fn(drained)`` runs after each
        pull-learn phase with the 1-based count (the chaos engine).

        On a mesh trainer this is rank 0's loop, as ``FleetLearner.run``'s:
        each pull-learn sends its control record (the IS size rides it) and
        the pulled batch; the other ranks run ``follow_pull``, and the TD
        priorities come back to rank 0 in global batch order."""
        if self.server.address is None:
            raise RuntimeError("call start() before run()")
        t = self.trainer
        control = control_plane(t)
        if control is not None:
            control.open()
        cfg = t.config
        mon = get_device_monitor().install()
        mon.begin_run()
        state = t.init() if state is None else state
        cstate, lstate = split_state(state)
        train = lstate.train
        draws = lstate.draws
        np_rng = np.random.default_rng(cfg.seed)
        deadline = time.monotonic() + minutes * 60 if minutes is not None else None
        for h in (self.sampler_wait, self.sampler_absorb, self.sample_assemble,
                  self.puller_wait):
            h.reset()
        put_s, fetch_s, phase_s = PercentileWindow(), PercentileWindow(), PercentileWindow()
        resume_from = resume_from or {}
        version = int(resume_from.get("param_version", 0)) + 1
        self.server.publish_params(version, snapshot_params(train))

        n_draws = cfg.learner_steps * cfg.batch_size
        drained = int(resume_from.get("drained", 0))
        drained_at_start = drained
        last_metrics: Dict[str, Any] = {}
        ep_ret_sum = float(resume_from.get("ep_return_sum", 0.0))
        ep_count = float(resume_from.get("ep_count", 0.0))
        env_steps_total = float(resume_from.get("env_steps_total", 0.0))
        episodes_total = float(resume_from.get("episodes_total", 0.0))
        occ = 0
        t0 = time.monotonic()
        train_t0: Optional[float] = None

        def emit_log(phase: int, scalars: Dict[str, float]) -> None:
            if metrics_fn is not None:
                metrics_fn(phase, scalars)
                return
            log_fn(f"sampler phase {phase}/{num_train_phases} "
                   + " ".join(f"{k} {v:.3g}" for k, v in scalars.items()))

        def fold_stats() -> None:
            nonlocal env_steps_total, ep_ret_sum, ep_count, episodes_total
            s = self.shards.pop_stats()
            env_steps_total += s["env_steps_delta"]
            ep_ret_sum += s["ep_return_sum"]
            ep_count += s["ep_count"]
            episodes_total += s["ep_count"]

        try:
            # ------------------------------------------------ absorb phase
            last_growth = time.monotonic()
            last_occ = -1
            t_wait = time.monotonic()
            last_poke = 0.0
            while self.shards.occupancy_total() < cfg.min_replay:
                if deadline is not None and time.monotonic() >= deadline:
                    break
                if self._direct and time.monotonic() - last_poke >= 0.25:
                    # No SEQS crosses the learner on the direct plane: poke
                    # the adverts, or the occupancy view stays at zero.
                    self.shards.refresh_adverts()
                    last_poke = time.monotonic()
                if health_fn is not None:
                    health_fn()
                occ = self.shards.occupancy_total()
                if occ != last_occ:
                    last_occ = occ
                    last_growth = time.monotonic()
                # Cold start pays actor spawn and start-up: double bound.
                bound = self.config.idle_timeout_s * (2.0 if occ == 0 else 1.0)
                if time.monotonic() - last_growth > bound:
                    raise RuntimeError(
                        f"sampler starved: shard occupancy stuck at {occ} for "
                        f"{bound:.0f}s; are the actors alive? (check flight.jsonl)")
                time.sleep(0.05)
            self.sampler_absorb.add(time.monotonic() - t_wait)

            # --shard-prefetch 1 (remote tier only): pull phase p+1 on a
            # thread while phase p learns; the draws stay sequential, the
            # priorities it samples under are one phase stale.
            prefetch_on = bool(self.config.shard_prefetch) and self._remote
            pending: Optional[_PrefetchPull] = None

            def pull_once() -> Dict[str, Any]:
                tr = obs_trace.maybe_start(trace_sample)
                t_req = time.time()
                t_assemble = time.monotonic()
                out = self._pull_phase_batches(n_draws, np_rng, tr)
                return {"out": out, "tr": tr, "t_req": t_req,
                        "assemble_s": time.monotonic() - t_assemble,
                        "stall_s": self._phase_stall_s}

            while drained < num_train_phases:
                if deadline is not None and time.monotonic() >= deadline:
                    break
                t_phase = time.monotonic()
                fold_stats()
                mon.on_phase(drained + 1)
                self._quality_ctx = (version, drained)
                if pending is not None:
                    pulled, pending = pending.result(), None
                else:
                    pulled = pull_once()
                if (prefetch_on and drained + 1 < num_train_phases
                        and (deadline is None or time.monotonic() < deadline)):
                    pending = _PrefetchPull(pull_once)
                tr = pulled["tr"]
                seq_np, probs_np, handles, occ = pulled["out"]
                t_batches = time.time()
                self.sample_assemble.add(pulled["assemble_s"])
                # One wait sample per phase, zeros included.
                self.sampler_wait.add(pulled["stall_s"])
                t_put = time.monotonic()
                with annotate("sampler/put"):
                    seqs, probs, buf = self._pack(
                        seq_np, probs_np, None if control is None else cstate.window)
                    if control is not None:
                        # Every rank hears the pull before anyone learns.
                        control.send(LEARN, width=n_draws, drained=drained + 1,
                                     size=occ, nbytes=buf.numel())
                        control.send_payload(buf)
                put_s.add(time.monotonic() - t_put)
                with annotate("sampler/learn"):
                    if drained == 0:
                        # The MFU numerator: the first pull-learn runs
                        # under the FLOP counter (results unchanged).
                        (train, prios_dev, last_metrics), flops = count_flops(
                            self._learn, train, seqs, probs, occ, draws)
                        mon.set_learn_cost(flops)
                    else:
                        train, prios_dev, last_metrics = self._learn(
                            train, seqs, probs, occ, draws)
                mon.note_learn()
                t_dispatch = time.time()
                # The one device-to-host copy of the phase: the TD
                # priorities the host-side shards need; it waits for the
                # K-th update.
                t_fetch = time.monotonic()
                with annotate("sampler/prio_fetch"):
                    prios = gather_priorities(t, prios_dev).cpu().numpy()
                fetch_s.add(time.monotonic() - t_fetch)
                t_learn_done = time.time()
                self._write_back(handles, prios)
                self.trained_seqs_total += n_draws
                self._obs_trained.inc(n_draws)
                if tr is not None:
                    obs_trace.record_hop("sample_req", pulled["t_req"], t_batches,
                                         tr.trace_id, draws=n_draws)
                    obs_trace.record_hop("batch_return", t_batches, t_dispatch,
                                         tr.trace_id, seqs=n_draws)
                    obs_trace.record_hop("learn", t_dispatch, t_learn_done, tr.trace_id)
                drained += 1
                phase_s.add(time.monotonic() - t_phase)
                if train_t0 is None:
                    train_t0 = time.monotonic()
                    self.server.mark_steady()
                    mon.mark_steady()
                if phase_fn is not None:
                    phase_fn(drained)
                if ckpt is not None and checkpoint_every > 0 and drained % checkpoint_every == 0:
                    self._save_checkpoint(
                        ckpt, drained, state, cstate,
                        dataclasses.replace(lstate, train=train),
                        {"drained": drained, "env_steps_total": env_steps_total,
                         "ep_return_sum": ep_ret_sum, "ep_count": ep_count,
                         "episodes_total": episodes_total, "param_version": version})
                if drained % max(self.config.publish_every, 1) == 0:
                    version += 1
                    self.server.publish_params(version, snapshot_params(train))
                    if log_every and drained % log_every == 0:
                        flight_event("param_publish", version=version)
                if log_every and drained % log_every == 0:
                    names = list(last_metrics)
                    fetched = torch.stack(
                        [last_metrics[k].float() for k in names]).tolist()
                    scalars = {
                        "episode_return_mean": ep_ret_sum / max(ep_count, 1.0),
                        "episodes": ep_count,
                        "env_steps": env_steps_total,
                        "learner_steps": float(train.step),
                        "replay_occupancy": float(occ),
                        **dict(zip(names, fetched)),
                    }
                    ep_ret_sum = 0.0
                    ep_count = 0.0
                    t._obs_publish(scalars)
                    emit_log(drained, scalars)
        except BaseException as e:
            if control is not None and not control.closed:
                control.fail(e)
            raise
        else:
            if control is not None:
                control.stop(drained)
        finally:
            if t.device.type == "cuda":
                torch.cuda.synchronize(t.device)
            mon.end_run()
            t_end = time.monotonic()
            fold_stats()
            wall = max(t_end - t0, 1e-9)
            _, sw_total, sw_p50, sw_p99 = self.sampler_wait.snapshot()
            _, sa_total, _, _ = self.sampler_absorb.snapshot()
            _, _, ss_p50, ss_p99 = self.sample_assemble.snapshot()
            _, pw_total, _, pw_p99 = self.puller_wait.snapshot()
            _, _, put_p50, put_p99 = put_s.snapshot()
            _, _, pf_p50, pf_p99 = fetch_s.snapshot()
            _, _, ph_p50, ph_p99 = phase_s.snapshot()
            srv = self.server
            drained_here = drained - drained_at_start
            trained = drained_here * n_draws
            if self._remote:
                # Real sockets: the shard set counted every sampler-leg byte
                # (REQ/BATCH/PRIO, their acks and the HELLOs).
                self.sample_bytes_total = self.shards.sample_bytes_total
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
                "trained_seqs": float(trained),
                "trained_seqs_total": float(self.trained_seqs_total),
                "wall_s": wall,
                "learner_steps_per_sec": drained_here * cfg.learner_steps / wall,
                "sample_bytes_total": float(self.sample_bytes_total),
                "bytes_per_trained_seq": self.sample_bytes_total / max(trained, 1),
                "seqs_bytes_total": float(srv.seqs_bytes_total),
                "collected_seqs": float(srv.seqs_received_total),
                "sheds": float(srv.shed_total),  # structurally 0
                "evictions": float(self.shards.evictions_total()),
                "replay_occupancy": float(self.shards.occupancy_total()),
                "sampler_wait_p50_ms": sw_p50 * 1e3,
                "sampler_wait_p99_ms": sw_p99 * 1e3,
                "sampler_wait_total_s": sw_total,
                "sampler_absorb_s": sa_total,
                "sample_p50_ms": ss_p50 * 1e3,
                "sample_p99_ms": ss_p99 * 1e3,
                "put_p50_ms": put_p50 * 1e3,
                "put_p99_ms": put_p99 * 1e3,
                "prio_fetch_p50_ms": pf_p50 * 1e3,
                "prio_fetch_p99_ms": pf_p99 * 1e3,
                "pull_learn_p50_ms": ph_p50 * 1e3,
                "pull_learn_p99_ms": ph_p99 * 1e3,
                "shard_pullers": float(self._pullers if self._remote else 1),
                "puller_wait_p99_ms": pw_p99 * 1e3,
                "puller_wait_total_s": pw_total,
                "overlap_fraction": max(0.0, 1.0 - (sw_total + sa_total) / wall),
                **quality_stats_columns(),
                **mon.run_stats(),
            }
            if control is not None:
                self._stats.update(control_records=float(control.records),
                                   payload_broadcasts=float(control.payloads))
            if self._remote:
                self._stats.update({
                    "shard_deaths": float(self.shards.deaths_total),
                    "shard_rejoins": float(self.shards.rejoins_total),
                    "shard_forward_bytes_total": float(self.shards.forward_bytes_total),
                })
            if train_t0 is not None:
                train_wall = max(t_end - train_t0, 1e-9)
                self._stats["train_wall_s"] = train_wall
                self._stats["train_learner_steps_per_sec"] = (
                    max(drained_here - 1, 0) * cfg.learner_steps / train_wall)
                self._stats["train_phases_per_sec"] = max(drained_here - 1, 0) / train_wall
        lstate = dataclasses.replace(lstate, train=train)
        return dataclasses.replace(merge_state(state, cstate, lstate),
                                   phase_idx=cstate.phase_idx + drained)

    def _save_checkpoint(self, ckpt, step: int, state, cstate, lstate,
                         counters: Dict) -> None:
        """One periodic learner checkpoint plus the counter sidecar."""
        ckpt.save(step, merge_state(state, cstate, lstate))
        save_fleet_counters(ckpt.directory, step, counters)
        prune_fleet_counters(ckpt.directory, ckpt.all_steps())
