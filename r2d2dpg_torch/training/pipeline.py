"""Pipelined collect/learn executor: env stepping overlapped with learning.

Port of ``r2d2dpg_tpu/training/pipeline.py``.  The phase-locked
``Trainer.run`` runs collect -> emit -> K learner updates in turn; here a
collector thread runs collect + emit and a learner thread (the caller's)
runs add + K updates, joined by a bounded staging queue:

::

    phase-locked            pipelined (this module)
    ------------            -----------------------
    C0 E0 L0 C1 E1 L1 ...   collector thread: C0 E0 | C1 E1 | C2 E2 | ...
                                                 \\      \\      \\
                                              [bounded staging queue]
                                                   \\      \\      \\
                            learner thread:         A0 L0 | A1 L1 | ...

    C = collect stride env steps   E = emit window        (collector)
    A = rank + add staged seqs     L = K learner updates  (drain_staged)

Contracts, as in the JAX package:

- **Schedule parity**: one drain per collect phase, in order, so the
  data-to-update ratio is the phase-locked one.  ``PipelineConfig(
  enabled=False)`` runs train phases through ``Trainer.train_phase`` on the
  calling thread, bitwise equal to ``Trainer.run`` at a fixed seed.
- **Staleness, one version per phase**: at each refresh phase ``k`` of a
  section (``k`` from 0, ``k % max(param_sync_every, 1) == 0``) the
  collector takes the params after ``max(0, k - queue_depth - 1)`` drains
  of the section and keeps them until the next refresh; each phase's
  version is recorded (``param_versions``).  The queue bound makes that
  version out before it is asked for: the collector has put item ``k - 1``,
  so the learner has taken item ``k - queue_depth - 1`` and published every
  drain before it.  When the learner is the slower side (the queue full)
  it is the newest version, which is what JAX's executor takes.  The
  behaviour params are at most ``param_sync_every + queue_depth`` phases
  old.
- **Backpressure**: ``put`` blocks the collector when the learner falls
  ``queue_depth`` phases behind, ``get`` blocks the learner when collection
  is the bottleneck.  Both waits feed registry histograms; ``stats()``
  gives their p50/p99 and totals and ``overlap_fraction``.

What eager torch needs that JAX's donation and program order gave:

- **Own modules.** ``functional_call`` swaps a module's parameters for
  the length of a call, so two threads must never run one module.  The
  executor deep-copies the agent's actor and critic once; the collector
  runs only the copies (``Trainer._collect(nets=...)``) and never calls
  into ``trainer.agent``'s modules, which stay the learner's.
- **Two CUDA streams.**  On a card the learner runs under one
  ``torch.cuda.Stream`` and the collector under another; both first wait
  for the caller's stream.  A tensor that crosses threads crosses streams,
  and goes with an event plus ``Tensor.record_stream(consumer)``: the
  staged sequences and the drained episode accumulators from the collector
  (the event rides the queue item; the learner waits on it before the
  drain), the published actor and critic params from the learner (the
  event rides the param box; the collector waits on it when it takes a
  snapshot).  ``record_stream`` keeps the caching allocator from handing
  a block back to the producer's stream while the consumer's kernels may
  still read it.  The priority scatter launches on the thread's current
  stream, the learner's.  The learner step is functional (it returns new
  tensors), so publishing needs no copy.  On the CPU none of this applies.
- **RNG fork rule.**  ``TrainerState.draws`` is one generator and two
  threads must not share it.  ``split_state`` keeps the state's draws for
  the collector and gives the learner a new ``Draws`` on the same device
  whose seed is one draw: ``torch.randint(0, 2**62, ())`` on a CPU
  generator seeded with ``(s + 0x9E3779B97F4A7C15 * (p + 1)) % 2**63``,
  where ``s`` is the state's generator's ``initial_seed()`` and ``p`` the
  state's phase index.  The state's own stream is not advanced.
  ``merge_state`` keeps the collector's draws.  With the version rule
  above, which params act in which phase is a function of the phase index,
  not of the threads' timing, so a pipelined run is a function of its seed:
  bitwise from the same seed, and the same on every rank of a mesh.  It is
  a different, equally valid trajectory from the phase-locked one, which
  ``enabled=False`` reproduces bitwise.
- **Counters.**  ``env_steps`` and ``phase_idx`` are Python ints, so they
  pass through the queue as they are; the drained accumulators are
  replaced with fresh zero tensors, as in JAX.
- **Collector errors** are re-raised on the calling thread after the join.

Host-driven collection (``HostSPMDTrainer``, ``parallel/hybrid.py``) runs
at any world size: the collector thread's ``trainer._collect`` is the
hybrid's host stride loop (``_stride_loop``) on the collector's modules and
stream.  The two threads share one process group, so the collector calls
no collective at any world size: it absorbs this rank's episode sums
unsummed, and the learner thread sums them over the mesh at its log fetch
(and what is left when the section ends).  Every collective of a section is
then the learner thread's (the gathered adds, the gradients, the gathered
priorities, the metrics mean, the log sum, the stop), in one order on every
rank.

**One stop for every rank.**  Under ``minutes`` each check is
``trainer._agree(clock >= deadline)``, rank 0's clock on every rank: once
per warm-up, fill and locked phase, and once per drain on the learner
thread.  On a stop every rank drops the items still queued, so every rank
drains the same phases; the state returned is the collector's after the
last drained phase, its draws rewound there (a host pool has stepped on,
as it has on a resume).  Without ``minutes`` nothing is added.

Shard-map trainers are refused, with JAX's message.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from r2d2dpg_torch.obs import flight_event, get_device_monitor, get_registry
from r2d2dpg_torch.obs.device import count_flops
from r2d2dpg_torch.obs import trace as obs_trace
from r2d2dpg_torch.replay.arena import StagedSequences, staged_nbytes
from r2d2dpg_torch.training.assembler import emit
from r2d2dpg_torch.training.draws import Draws
from r2d2dpg_torch.training.trainer import Trainer, TrainerState
from r2d2dpg_torch.tree import tree_leaves
from r2d2dpg_torch.utils.profiling import annotate

# A single queue wait this long lands in the flight recorder as a
# ``queue_stall`` event (the histograms keep the full distribution).
_STALL_EVENT_S = 1.0
_FORK_MULT = 0x9E3779B97F4A7C15


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static executor knobs (the trainer's own config governs the rest)."""

    enabled: bool = True  # False = phase-locked control schedule
    queue_depth: int = 2  # staging-queue capacity, in collect phases
    prefetch: bool = True  # double-buffered batch sampling in the drain
    # Experience-path trace sampling (obs/trace.py): the in-process hops
    # collect, enqueue, arena_add, learn.  0 = off: no span, no sync.
    trace_sample: float = 0.0


@dataclasses.dataclass(frozen=True)
class CollectorState:
    """The collector thread's slice of ``TrainerState`` (no learner subtree).

    Field names match ``TrainerState``, so ``Trainer._collect`` runs on it
    unchanged."""

    env_state: Any
    obs: torch.Tensor
    reset: torch.Tensor
    actor_carry: Any
    critic_carry: Any
    noise_state: torch.Tensor
    window: Any
    draws: Any
    phase_idx: int
    env_steps: int
    episode_return: torch.Tensor
    completed_return_sum: torch.Tensor
    completed_count: torch.Tensor


@dataclasses.dataclass(frozen=True)
class LearnerState:
    """The learner thread's slice of ``TrainerState``."""

    train: Any
    arena: Any
    draws: Any


_COLLECT_FIELDS = tuple(f.name for f in dataclasses.fields(CollectorState))


def drain_staged(
    trainer: Trainer,
    lstate: LearnerState,
    staged: StagedSequences,
    *,
    learn: bool = True,
    prefetch: bool = True,
) -> Tuple[LearnerState, Dict[str, torch.Tensor]]:
    """The learner-side drain body: rank -> arena add -> K updates
    (double-buffered sampling when ``prefetch``).

    ``staged.priorities`` may be resolved by the producer or ``None``
    (ranked here with the learner's current nets), then relaid by the
    trainer's ``_reshard_add`` hook.  The entry stamp is the learner's step.
    ``learn=False`` absorbs without updating.  The learner draws from
    ``lstate.draws``, the stream the trainer's ``_fold_axis`` gave it."""
    t = trainer
    with annotate("pipeline_add"):
        prios = staged.priorities
        if prios is None:
            prios = t._initial_priorities(lstate.train, lstate.arena, staged.seq)
        seq, prios = t._reshard_add(staged.seq, prios)
        arena = t.arena.add_staged(
            lstate.arena,
            dataclasses.replace(staged, seq=seq, priorities=prios),
            stamp=lstate.train.step,
        )
    if not learn:
        return dataclasses.replace(lstate, arena=arena), {}
    with annotate("pipeline_learn"):
        train, arena, metrics = t._learn_many(
            lstate.train, arena, lstate.draws, prefetch=prefetch
        )
    return LearnerState(train=train, arena=arena, draws=lstate.draws), metrics


def bucket_width(available: int, limit: int) -> int:
    """The largest power of two <= min(available, limit), at least 1 (a
    coalesced drain's width, so a run sees a bounded set of widths)."""
    n = max(1, min(available, limit))
    return 1 << (n.bit_length() - 1)


def coalesce_from_queue(q: "queue.Queue", first: Any, limit: int) -> list:
    """``first`` (already taken) plus queued items up to the power-of-two
    bucket of ``limit``; never blocks.  A queue that carries a termination
    sentinel is coalesced with ``limit=1`` or filtered by its caller."""
    width = bucket_width(1 + q.qsize(), limit)
    items = [first]
    while len(items) < width:
        try:
            items.append(q.get_nowait())
        except queue.Empty:
            break  # qsize raced low: a narrower pull, never a stall
    return items


def learner_draws(draws: Any, phase_idx: int) -> Draws:
    """The learner's ``Draws`` under the fork rule (module docstring)."""
    gen = getattr(draws, "generator", None)
    if gen is None:
        raise TypeError(
            "split_state forks a Draws (seeded generator); "
            f"got {type(draws).__name__}"
        )
    seed = (gen.initial_seed() + _FORK_MULT * (int(phase_idx) + 1)) % 2**63
    g = torch.Generator().manual_seed(seed)
    return Draws(int(torch.randint(0, 2**62, (), generator=g)), draws.device)


def split_state(state: TrainerState) -> Tuple[CollectorState, LearnerState]:
    """Partition a ``TrainerState`` into the two threads' slices (the
    collector keeps the draws; the learner's fork per the rule above)."""
    return (
        CollectorState(**{f: getattr(state, f) for f in _COLLECT_FIELDS}),
        LearnerState(
            train=state.train,
            arena=state.arena,
            draws=learner_draws(state.draws, state.phase_idx),
        ),
    )


def merge_state(
    state: TrainerState,
    cstate: CollectorState,
    lstate: LearnerState,
    behavior_params: Any = None,
) -> TrainerState:
    """Reassemble a ``TrainerState`` after a pipelined section: every
    field from the two slices (the draws are the collector's) plus the
    final behaviour snapshot (a copy of the learner's actor params when
    none is given)."""
    if behavior_params is None:
        behavior_params = {k: v.clone() for k, v in lstate.train.actor_params.items()}
    return dataclasses.replace(
        state,
        train=lstate.train,
        arena=lstate.arena,
        behavior_params=behavior_params,
        **{f: getattr(cstate, f) for f in _COLLECT_FIELDS},
    )


def _on(stream) -> contextlib.AbstractContextManager:
    """Make ``stream`` this thread's current stream (no-op for None)."""
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def _expiry(trainer: Trainer, deadline: Optional[float]) -> Callable[[], bool]:
    """The stop check of a run: rank 0's ``clock >= deadline`` on every
    rank (one ``_agree``), or always False without a deadline."""
    if deadline is None:
        return lambda: False
    return lambda: trainer._agree(time.monotonic() >= deadline)


def _hand_over(tree, consumer) -> Optional["torch.cuda.Event"]:
    """Hand ``tree``'s tensors from this thread's current stream to
    ``consumer``: each is marked in use there (``record_stream``), and the
    returned event, recorded on the current stream, is what the consumer
    waits on.  None (nothing to do) on the CPU."""
    leaves = tree_leaves(tree)
    if consumer is None:
        return None
    for x in leaves:
        x.record_stream(consumer)
    event = torch.cuda.Event()
    event.record()
    return event


def _take(event) -> None:
    """Order this thread's current stream after a ``_hand_over`` event."""
    if event is not None:
        torch.cuda.current_stream().wait_event(event)


class _ParamBox:
    """The learner's published behaviour params by version (drains done in
    the section), the newest ``keep`` of them, each ``(actor, critic,
    event)`` with the event that makes it ready on the collector's stream."""

    def __init__(self, keep: int):
        self._cond = threading.Condition()
        self._ring: Dict[int, tuple] = {}
        self._keep = keep

    def publish(self, version: int, actor, critic, event) -> None:
        with self._cond:
            self._ring[version] = (actor, critic, event)
            for old in [v for v in self._ring if v <= version - self._keep]:
                del self._ring[old]
            self._cond.notify_all()

    def take(self, version: int, stop: threading.Event) -> Tuple[Optional[tuple], bool]:
        """``(snapshot, waited)`` of ``version``, waiting while it is not
        out yet; the snapshot is None when ``stop`` is set first."""
        waited = False
        with self._cond:
            while version not in self._ring:
                if self._ring and min(self._ring) > version:
                    raise RuntimeError(
                        f"param version {version} left the ring "
                        f"({sorted(self._ring)})")
                if stop.is_set():
                    return None, waited
                waited = True
                self._cond.wait(0.2)
            return self._ring[version], waited


class PipelineExecutor:
    """Drives a trainer's phase schedule with collect and learn overlapped.

    Works with the base ``Trainer`` and with the host-driven
    ``HostSPMDTrainer`` at any world size.  Shard-map trainers (``axis``
    set) are refused.  Warm-up and
    replay-fill phases run phase-locked on the calling thread: the learner
    has nothing to do until replay holds ``min_replay`` sequences.

    After a pipelined section ``param_versions`` holds the version each
    collect phase acted with and ``version_waits`` how many refreshes had to
    wait for theirs (the version rule says none).
    """

    def __init__(self, trainer: Trainer, config: PipelineConfig = PipelineConfig()):
        if getattr(trainer, "axis", None) is not None:
            raise ValueError(
                "PipelineExecutor needs a host-visible collect/learn "
                "boundary; shard_map trainers (SPMDTrainer) fuse whole "
                "phases — use the base Trainer or HostSPMDTrainer"
            )
        if config.queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        self.trainer = trainer
        self.config = config
        # The collector's own modules (module docstring: "Own modules").
        self.collector_nets = (
            copy.deepcopy(trainer.agent.actor),
            copy.deepcopy(trainer.agent.critic),
        )
        self._reset_stats()

    # ------------------------------------------------------- the two sides
    def _collect_phase_pipelined(self, cstate, behavior, critic_params):
        """One collect phase on the collector thread: stride env steps on
        the collector's modules (the host stride loop for a host-driven
        trainer), window shift, emit."""
        with annotate("pipeline_collect"):
            cstate = self.trainer._collect(
                cstate, behavior=behavior, critic_params=critic_params,
                nets=self.collector_nets,
            )
        with annotate("pipeline_emit"):
            staged = StagedSequences(seq=emit(cstate.window))
        return cstate, staged

    def _publish(self, box, version, train, phase=-1, record=True, consumer=None):
        """Publish the learner's behaviour params after ``version`` drains.

        Every drain publishes, even when the collector reads only every
        ``param_sync_every``-th phase, so publication adds no age to the
        staleness bound.  ``record=False`` skips the flight event (a
        per-drain event would flood the ring; the caller records on the
        log cadence)."""
        actor = train.actor_params
        critic = self.trainer.agent.behavior_critic_params(train)
        box.publish(version, actor, critic, _hand_over((actor, critic), consumer))
        if record:
            flight_event("param_publish", phase=phase)
        return actor

    # ------------------------------------------------------------------ runs
    def _reset_stats(self) -> None:
        # Registry histograms, reset at each section start so stats() is
        # per section.
        reg = get_registry()
        self.learner_wait = reg.histogram(
            "r2d2dpg_pipeline_learner_wait_seconds",
            "learner thread blocked on the staging queue (starvation)",
        )
        self.collect_wait = reg.histogram(
            "r2d2dpg_pipeline_collect_wait_seconds",
            "collector thread blocked on the staging queue (backpressure)",
        )
        self._obs_queue_depth = reg.gauge(
            "r2d2dpg_pipeline_staging_queue_depth",
            "staged collect phases awaiting drain",
        )
        self.learner_wait.reset()
        self.collect_wait.reset()
        self._stats: Dict[str, float] = {}
        self.param_versions: list = []
        self.version_waits = 0

    def stats(self) -> Dict[str, float]:
        """Instrumentation of the most recent pipelined section.

        ``overlap_fraction`` = 1 - learner_wait_total / wall: the share of
        the section's wall clock in which the learner had staged data (1.0:
        collection fully hidden; 0.0: phase-locked in effect).  The device
        monitor's run-window columns ride along (``obs/device.py``)."""
        return dict(self._stats)

    def run(
        self,
        num_phases: int,
        state: Optional[TrainerState] = None,
        log_every: int = 50,
        log_fn=print,
        metrics_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
        minutes: Optional[float] = None,
        learner_hook: Optional[Callable[[int, Any], Any]] = None,
    ) -> TrainerState:
        """Drive the schedule (warm-up -> fill -> train) from
        ``state.phase_idx`` up to phase ``num_phases``, with
        ``Trainer.run``'s log cadence; train phases run pipelined when
        enabled.

        ``metrics_fn(phase, scalars)``, when given, receives the log
        scalars instead of ``log_fn`` a formatted line.  ``minutes`` bounds
        the wall clock: no phase starts once it is spent, by rank 0's clock
        (module docstring, "One stop for every rank").
        ``learner_hook(n, train)`` runs on the learner after its n-th train
        phase and returns the train state to go on with (fault drills)."""
        t = self.trainer
        state = t.init() if state is None else state
        deadline = time.monotonic() + minutes * 60 if minutes is not None else None
        expired = _expiry(t, deadline)
        warm, fill = t.window_fill_phases, t.replay_fill_phases
        locked_until = min(num_phases, warm + fill)

        def emit_log(phase: int, ep: Dict[str, float], scalars: Dict[str, float]):
            if metrics_fn is not None:
                metrics_fn(phase, {**ep, **scalars})
                return
            log_fn(
                f"phase {phase}/{num_phases} "
                f"env_steps {int(ep['env_steps'])} "
                f"return {ep['episode_return_mean']:.1f} "
                f"({int(ep['episodes'])} eps) "
                + " ".join(f"{k} {v:.3g}" for k, v in scalars.items())
            )

        phase = state.phase_idx
        stopped = False
        while phase < locked_until:
            if expired():
                stopped = True
                break
            if phase < warm:
                with annotate("pipeline/warmup_phase"):
                    state = t.collect_phase(state)
            else:
                with annotate("pipeline/fill_phase"):
                    state = t.fill_phase(state)
            phase += 1
            if log_every and phase % log_every == 0:
                state, ep = t.pop_episode_metrics(state)
                emit_log(phase, ep, {})

        if phase < num_phases and not stopped and not expired():
            run = self._run_pipelined if self.config.enabled else self._run_locked
            state = run(state, phase, num_phases, log_every, emit_log, expired,
                        learner_hook)
        return state

    def run_train_phases(
        self, state: TrainerState, n: int, log_every: int = 0, log_fn=print
    ) -> TrainerState:
        """Exactly ``n`` TRAIN phases from ``state`` (replay must already
        hold ``min_replay`` sequences): pipelined when enabled, phase-locked
        otherwise.  No warm-up or fill bookkeeping."""

        def emit_log(phase, ep, scalars):
            log_fn(f"train phase {phase}/{n} " + " ".join(
                f"{k} {v:.3g}" for k, v in {**ep, **scalars}.items()
            ))

        run = self._run_pipelined if self.config.enabled else self._run_locked
        return run(state, 0, n, log_every, emit_log, _expiry(self.trainer, None), None)

    def _run_locked(
        self, state, phase, num_phases, log_every, emit_log, expired, learner_hook
    ) -> TrainerState:
        """The phase-locked control schedule: ``Trainer.train_phase`` with
        ``Trainer.run``'s cadence (the bitwise anchor)."""
        t = self.trainer
        last_metrics: Dict[str, torch.Tensor] = {}
        done = 0
        while phase < num_phases:
            if expired():
                break
            with annotate("trainer/train_phase"):
                state, last_metrics = t.train_phase(state)
            done += 1
            if learner_hook is not None:
                state = dataclasses.replace(state, train=learner_hook(done, state.train))
            phase += 1
            if log_every and phase % log_every == 0:
                state, ep = t.pop_episode_metrics(state)
                names = list(last_metrics)
                values = torch.stack([last_metrics[k] for k in names]).tolist()
                emit_log(phase, ep, dict(zip(names, values)))
        return state

    def _run_pipelined(
        self, state, phase0, num_phases, log_every, emit_log, expired, learner_hook
    ) -> TrainerState:
        t = self.trainer
        cfg = self.config
        n_train = num_phases - phase0
        self._reset_stats()
        # The learner thread owns the device monitor's run window.
        mon = get_device_monitor().install()
        mon.begin_run()
        if t.device.type == "cuda":
            learner_stream = torch.cuda.Stream(t.device)
            collector_stream = torch.cuda.Stream(t.device)
            caller = torch.cuda.current_stream(t.device)
            learner_stream.wait_stream(caller)
            collector_stream.wait_stream(caller)
        else:
            learner_stream = collector_stream = caller = None
        cstate, lstate = split_state(state)
        if getattr(getattr(t, "mesh", None), "rank", 0):
            # The accumulators come in summed over the mesh, and the
            # collector's are its rank's own: rank 0 carries the sums that
            # came in, the other ranks start from zero.
            with _on(collector_stream):
                zero = torch.zeros((), device=t.device)
                cstate = dataclasses.replace(
                    cstate, completed_return_sum=zero, completed_count=zero.clone())
        box = _ParamBox(keep=cfg.queue_depth + 2)
        with _on(learner_stream):
            self._publish(box, 0, lstate.train, phase0, consumer=collector_stream)
        q: queue.Queue = queue.Queue(maxsize=cfg.queue_depth)
        # Live depth at scrape time; rebound to 0 when the section ends.
        self._obs_queue_depth.set_fn(q.qsize)
        stop = threading.Event()
        collector_err: list = []
        sync_every = max(t.config.param_sync_every, 1)
        versions = self.param_versions

        def collector() -> None:
            cs = cstate
            try:
                with _on(collector_stream):
                    for k in range(n_train):
                        if stop.is_set():
                            break
                        gphase = phase0 + k + 1
                        if k % sync_every == 0:
                            # The version rule (module docstring).
                            version = max(0, k - cfg.queue_depth - 1)
                            t_wait = time.monotonic()
                            snap, waited = box.take(version, stop)
                            if snap is None:
                                break
                            if waited:
                                self.version_waits += 1
                                flight_event(
                                    "param_wait", phase=gphase, version=version,
                                    seconds=round(time.monotonic() - t_wait, 3))
                            behavior, critic, event = snap
                            _take(event)
                        versions.append(version)
                        tr = obs_trace.maybe_start(cfg.trace_sample)
                        with annotate("pipeline/collect"):
                            cs, staged = self._collect_phase_pipelined(
                                cs, behavior, critic
                            )
                        ep_refs = None
                        if log_every and gphase % log_every == 0:
                            # The collector owns the episode accumulators:
                            # drain them here; they join the learner's one
                            # fetch at log time.
                            ep_refs = (
                                cs.env_steps,
                                cs.completed_return_sum,
                                cs.completed_count,
                            )
                            zero = torch.zeros((), device=t.device)
                            cs = dataclasses.replace(
                                cs, completed_return_sum=zero,
                                completed_count=zero.clone(),
                            )
                        event = _hand_over(
                            (staged, ep_refs and ep_refs[1:]), learner_stream
                        )
                        if tr is not None:
                            # The collect hop ends when the batch is made
                            # (sampled phases only).
                            if event is not None:
                                event.synchronize()
                            tr.t_collect_end = time.time()
                            obs_trace.record_hop(
                                "collect", tr.t_collect_start, tr.t_collect_end,
                                tr.trace_id,
                            )
                        gen = getattr(cs.draws, "generator", None)
                        item = (gphase, staged, ep_refs, tr, event, cs,
                                None if gen is None else gen.get_state())
                        t_wait = time.monotonic()
                        while not stop.is_set():
                            try:
                                q.put(item, timeout=0.2)
                                break
                            except queue.Full:
                                continue
                        waited = time.monotonic() - t_wait
                        self.collect_wait.add(waited)
                        if waited >= _STALL_EVENT_S:
                            flight_event(
                                "queue_stall", side="collector",
                                phase=gphase, seconds=round(waited, 3),
                            )
            except BaseException as e:  # re-raised on the calling thread
                collector_err.append(e)
            finally:
                q.put(None)

        thread = threading.Thread(target=collector, name="pipeline-collector", daemon=True)
        t0 = time.monotonic()
        thread.start()
        ls = lstate
        # The collector's state after the last drained phase, and its draws'.
        gen = getattr(cstate.draws, "generator", None)
        kept = (cstate, None if gen is None else gen.get_state())
        behavior_final = None
        drained = 0
        try:
            with _on(learner_stream):
                while True:
                    t_wait = time.monotonic()
                    item = q.get()
                    waited = time.monotonic() - t_wait
                    self.learner_wait.add(waited)
                    if waited >= _STALL_EVENT_S:
                        flight_event(
                            "queue_stall", side="learner",
                            phase=phase0 + drained + 1, seconds=round(waited, 3),
                        )
                    if item is None or expired():
                        break  # a stop: every rank drops what is queued
                    gphase, staged, ep_refs, tr, event, *after = item
                    kept = tuple(after)
                    _take(event)
                    t_dequeue = time.time()
                    mon.on_phase(drained + 1)
                    with annotate("pipeline/learn"):
                        if drained == 0:
                            # The MFU numerator: the first drain runs under
                            # the FLOP counter (results unchanged).
                            (ls, metrics), flops = count_flops(
                                drain_staged, t, ls, staged, prefetch=cfg.prefetch)
                            mon.set_learn_cost(flops)
                        else:
                            ls, metrics = drain_staged(t, ls, staged, prefetch=cfg.prefetch)
                    mon.note_learn()
                    if learner_hook is not None:
                        ls = dataclasses.replace(
                            ls, train=learner_hook(drained + 1, ls.train))
                    if tr is not None:
                        # enqueue = queue residency, arena_add = the drain's
                        # dispatch window, learn = until the learner stream
                        # has run it (sampled phases only).
                        t_dispatch_end = time.time()
                        obs_trace.record_hop(
                            "enqueue", tr.t_collect_end, t_dequeue, tr.trace_id)
                        obs_trace.record_hop(
                            "arena_add", t_dequeue, t_dispatch_end, tr.trace_id,
                            bytes=staged_nbytes(staged))
                        if learner_stream is not None:
                            learner_stream.synchronize()
                        obs_trace.record_hop(
                            "learn", t_dispatch_end, time.time(), tr.trace_id)
                    behavior_final = self._publish(
                        box, drained + 1, ls.train, gphase,
                        record=ep_refs is not None, consumer=collector_stream,
                    )
                    drained += 1
                    if drained == 1:
                        mon.mark_steady()
                    if ep_refs is not None:
                        # ONE fetch per log cadence: the episode sums over
                        # the mesh (this thread's one sum), the arena's
                        # priority sum and the phase's learn metrics.
                        env_steps, ret_sum, count = ep_refs
                        names = list(metrics)
                        ret_sum, count = t._psum(torch.stack([ret_sum, count]))
                        fetched = torch.stack(
                            [ret_sum, count, ls.arena.priority.sum()]
                            + [metrics[k].float() for k in names]
                        ).tolist()
                        ret_sum, count, psum = fetched[:3]
                        ep = {
                            "episode_return_mean": ret_sum / max(count, 1.0),
                            "episodes": count,
                            "env_steps": float(env_steps),
                            "learner_steps": float(ls.train.step),
                        }
                        learn = dict(zip(names, fetched[3:]))
                        t.arena.observe_state_scalars(
                            float(t.arena.size(ls.arena)), psum,
                            float(ls.arena.total_added),
                        )
                        t._obs_publish({**ep, **learn})
                        emit_log(gphase, ep, learn)
        finally:
            stop.set()
            # Unblock a collector mid-put, then collect its state.
            while thread.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    thread.join(timeout=0.2)
            thread.join()
            self._obs_queue_depth.set(0.0)
            mon.end_run()
            # The caller's stream goes on with what the side streams made:
            # it waits for them, and their blocks are marked in use there.
            if caller is not None:
                caller.wait_stream(learner_stream)
                caller.wait_stream(collector_stream)
            _hand_over((dataclasses.replace(kept[0], draws=None), ls.train), caller)
        if collector_err:
            raise collector_err[0]
        if learner_stream is not None:
            torch.cuda.synchronize(t.device)
        wall = max(time.monotonic() - t0, 1e-9)
        _, lw_total, lw_p50, lw_p99 = self.learner_wait.snapshot()
        _, cw_total, cw_p50, cw_p99 = self.collect_wait.snapshot()
        self._stats = {
            "train_phases": float(drained),
            "wall_s": wall,
            "learner_steps_per_sec": drained * t.config.learner_steps / wall,
            "learner_wait_p50_ms": lw_p50 * 1e3,
            "learner_wait_p99_ms": lw_p99 * 1e3,
            "learner_wait_total_s": lw_total,
            "collect_wait_p50_ms": cw_p50 * 1e3,
            "collect_wait_p99_ms": cw_p99 * 1e3,
            "collect_wait_total_s": cw_total,
            "overlap_fraction": min(max(1.0 - lw_total / wall, 0.0), 1.0),
            **mon.run_stats(),
        }
        cs, draw_state = kept
        if draw_state is not None:
            cs.draws.generator.set_state(draw_state)
        # What the collector absorbed since the last log, over the mesh.
        ret_sum, count = t._psum(torch.stack(
            [cs.completed_return_sum, cs.completed_count]))
        cs = dataclasses.replace(cs, completed_return_sum=ret_sum,
                                 completed_count=count)
        return merge_state(state, cs, ls, behavior_final)
