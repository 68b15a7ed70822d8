"""Composable topology: collect / ingest / sample / learn as one config.

Port of ``r2d2dpg_tpu/topology.py``: the resolved ``Topology`` of a run,
the one refusal table, the flag checks, and the assembly helpers
``train.py`` builds the run from.  The four stages and their contracts:

- **collect**: who steps the environments.  ``local`` (this process) or
  ``fleet`` (actor subprocesses, ``fleet/actor.py``).
- **ingest**: how collected experience reaches replay.  ``fused`` (the
  phase-locked loop adds in place), ``staging_queue`` (the pipelined
  executor), ``central_drain`` (``FleetLearner``) or ``sharded_rings``
  (the sampler path's replay shards).
- **sample**: where batches come from.  ``arena`` (the device arena) or
  ``two_level`` (the sampler's shard quotas, then within-shard draws).
- **learn**: the layout, ``single_device``, ``dp_mesh``
  (``parallel/dp_learner.py``) or ``spmd_mesh`` (``parallel/spmd.py``),
  and the schedule, ``phase_locked``, ``pipelined_overlap``,
  ``drain_paced`` or ``free_running``.

Every pairing the port refuses lives in ``REFUSALS``, each row with the
JAX row's message; ``train.py`` has no refusal branch of its own.  The
rows differ from the JAX table on purpose in these places:

- ``pipeline-x-nan-inject`` has no row: the port's pipeline runs
  ``--nan-inject-phase`` through a learner hook.
- ``pipeline-x-phase-subsystems`` is narrowed to ``--profile-phases``: the
  port's pipeline runs ``--resume`` and ``--eval-every``.  Its message
  names only that flag.
- ``multiprocess-not-yet-ported`` is the port's own: a world of more than
  one process refuses ``--pipeline``.  The pipelined executor's collector
  and learner threads would both call collectives on the one process
  group, which needs an order across ranks that is not ported.

``Refusal.processes`` is the process count a row's ``argv`` needs to fire
(the multi-process rows are pinned through ``validate`` with it).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

from r2d2dpg_torch.fleet.chaos import (
    DIRECT_FAULTS,
    SAMPLER_FAULTS,
    SHARD_FAULTS,
    parse_chaos_spec,
)

# --------------------------------------------------------------- topology


@dataclasses.dataclass(frozen=True)
class Topology:
    """The resolved four-stage shape of one run (flag-derivable half).

    Everything is determined by the CLI flags.  ``describe()`` is the
    one-line stamp a run prints and writes to ``topology.txt``, letter for
    letter the JAX package's."""

    collect: str  # "local" | "fleet"
    ingest: str  # "fused" | "staging_queue" | "central_drain" | "sharded_rings"
    sample: str  # "arena" | "two_level"
    learn: str  # "single_device" | "dp_mesh" | "spmd_mesh"
    schedule: str  # "phase_locked" | "pipelined_overlap" | "drain_paced" | "free_running"
    actors: int = 0
    replay_shards: int = 0
    learner_dp: int = 0
    spmd: int = 0
    pipeline: bool = False
    # Where the sampler path's shards live: 0 = in-learner loopback (the
    # pinned off-setting), N = supervised standalone shard processes
    # (fleet/shard.py) — a refinement of the sharded_rings/two_level
    # stages, not a new stage.
    shard_procs: int = 0
    # How actor SEQS traffic reaches the shards: False = the
    # learner-forwarded path (the pinned off-setting), True = actors dial
    # their assigned shard directly and the control connection carries
    # only params/telem/accounting.  A refinement of the sharded_rings
    # stage, not a new stage.
    shard_direct: bool = False

    def describe(self) -> str:
        return (
            f"collect={self.collect} ingest={self.ingest} "
            f"sample={self.sample} learn={self.learn} "
            f"schedule={self.schedule} actors={self.actors} "
            f"replay_shards={self.replay_shards} "
            f"shard_procs={self.shard_procs} "
            f"shard_direct={int(self.shard_direct)} "
            f"learner_dp={self.learner_dp} spmd={self.spmd}"
        )

    @property
    def composed(self) -> bool:
        """More than one scaling axis active."""
        axes = sum(
            1
            for v in (self.actors, self.replay_shards, self.learner_dp)
            if v
        )
        return axes >= 2


def resolve(args) -> Topology:
    """Flags -> the four-stage topology (no validation; see validate)."""
    fleet = bool(args.actors)
    sharded = bool(fleet and args.replay_shards)
    if sharded:
        ingest, sample, schedule = "sharded_rings", "two_level", "free_running"
    elif fleet:
        ingest, sample, schedule = "central_drain", "arena", "drain_paced"
    elif args.pipeline:
        ingest, sample, schedule = "staging_queue", "arena", "pipelined_overlap"
    else:
        ingest, sample, schedule = "fused", "arena", "phase_locked"
    if args.learner_dp:
        learn = "dp_mesh"
    elif args.spmd:
        learn = "spmd_mesh"
    else:
        learn = "single_device"
    return Topology(
        collect="fleet" if fleet else "local",
        ingest=ingest,
        sample=sample,
        learn=learn,
        schedule=schedule,
        actors=int(args.actors or 0),
        replay_shards=int(args.replay_shards or 0),
        learner_dp=int(args.learner_dp or 0),
        spmd=int(args.spmd or 0),
        pipeline=bool(args.pipeline),
        shard_procs=int(getattr(args, "shard_procs", 0) or 0),
        shard_direct=bool(getattr(args, "shard_direct", 0)),
    )


# ---------------------------------------------------------- refusal table


@dataclasses.dataclass(frozen=True)
class Refusal:
    """One still-unsupported pairing: predicate, reason, evidence argv.

    ``argv`` is a minimal flag set (appended to ``--config pendulum_tiny``)
    that triggers exactly this row at ``processes`` processes; the
    parametrized pin in ``tests/test_torch_topology.py`` drives it and
    asserts the refusal's message."""

    key: str
    when: Callable[[object, int], bool]  # (args, process_count) -> refused?
    reason: str  # the SystemExit message
    match: str  # stable fragment of the message
    argv: Tuple[str, ...]
    processes: int = 1


def _fleet_only_knobs(a) -> bool:
    return (
        a.fleet_wire != "f32"
        or a.fleet_compress != "none"
        or a.drain_coalesce != 1
        or a.chaos_spec is not None
        or a.fleet_token is not None
        or a.fleet_heartbeat is not None
        or a.fleet_shed_after is not None
    )


def _autoscale_only_knobs(a) -> bool:
    return (
        bool(a.autoscale_dry_run)
        or a.autoscale_min != 1
        or a.autoscale_max != 0
        or a.autoscale_cooldown != 30.0
        or a.autoscale_every != 2.0
        or a.autoscale_fire != 3
    )


def _chaos_kinds(a) -> set:
    return {f.kind for f in parse_chaos_spec(a.chaos_spec)} if a.chaos_spec else set()


def _chaos_sampler_faults(a) -> bool:
    return not a.replay_shards and bool(_chaos_kinds(a) & SAMPLER_FAULTS)


def _chaos_shard_faults(a) -> bool:
    return not a.shard_procs and bool(_chaos_kinds(a) & SHARD_FAULTS)


def _chaos_direct_faults(a) -> bool:
    return not a.shard_direct and bool(_chaos_kinds(a) & DIRECT_FAULTS)


def _sampler_pull_knobs(a) -> bool:
    return bool(a.shard_pullers or a.shard_prefetch)


# ONE table.  Every pairing refused anywhere in the CLI lives here, with
# its reason; value checks (bounds, divisibility, grammar) stay in
# validate() below: they are not pairings.
REFUSALS: Tuple[Refusal, ...] = (
    # ------------------------------------------------- pipelined executor
    Refusal(
        key="pipeline-x-phase-subsystems",
        when=lambda a, np: bool(a.pipeline and a.profile_phases),
        reason=(
            "--pipeline 1 does not support --profile-phases yet (the "
            "executor owns the phase loop; docs/TOPOLOGY.md)"
        ),
        match="does not support",
        argv=("--pipeline", "1", "--profile-phases", "2"),
    ),
    # ------------------------------------------------------- fleet actors
    Refusal(
        key="actors-x-pipeline",
        when=lambda a, np: bool(a.actors and a.pipeline),
        reason=(
            "--actors N does not compose with --pipeline 1: both executors "
            "own the phase loop (docs/TOPOLOGY.md)"
        ),
        match="does not compose",
        argv=("--actors", "2", "--pipeline", "1"),
    ),
    Refusal(
        key="actors-x-spmd",
        when=lambda a, np: bool(a.actors and a.spmd),
        reason=(
            "--actors N does not compose with --spmd: shard_map trainers "
            "fuse whole phases, hiding the drain boundary the fleet "
            "learner needs (use --learner-dp for a fleet-fed mesh; "
            "docs/TOPOLOGY.md)"
        ),
        match="does not compose",
        argv=("--actors", "2", "--spmd", "2"),
    ),
    Refusal(
        key="actors-x-eval-every",
        when=lambda a, np: bool(a.actors and a.eval_every),
        reason=(
            "--actors N does not compose with --eval-every: the fleet "
            "learner owns the phase loop; run the final-checkpoint eval "
            "instead (docs/TOPOLOGY.md)"
        ),
        match="does not compose",
        argv=("--actors", "2", "--eval-every", "5"),
    ),
    Refusal(
        key="actors-x-profile-phases",
        when=lambda a, np: bool(a.actors and a.profile_phases),
        reason=(
            "--actors N does not compose with --profile-phases: the "
            "profiler brackets the phase-locked loop this process never "
            "runs under a fleet (docs/TOPOLOGY.md)"
        ),
        match="does not compose",
        argv=("--actors", "2", "--profile-phases", "2"),
    ),
    Refusal(
        key="actors-x-nan-inject",
        when=lambda a, np: bool(a.actors and a.nan_inject_phase is not None),
        reason=(
            "--actors N does not compose with --nan-inject-phase: the "
            "poison targets the in-process collect loop actors own "
            "(docs/TOPOLOGY.md)"
        ),
        match="does not compose",
        argv=("--actors", "2", "--nan-inject-phase", "1"),
    ),
    Refusal(
        key="actors-x-overlap-learner",
        when=lambda a, np: bool(a.actors and a.overlap_learner),
        reason=(
            "--actors N does not compose with --overlap-learner 1: the "
            "interleaved updates hide under a host env pool this process "
            "does not step under a fleet (docs/TOPOLOGY.md)"
        ),
        match="does not compose",
        argv=("--actors", "2", "--overlap-learner", "1"),
    ),
    Refusal(
        key="fleet-knobs-without-actors",
        when=lambda a, np: bool(not a.actors and _fleet_only_knobs(a)),
        reason=(
            "--fleet-wire/--fleet-compress/--drain-coalesce/"
            "--fleet-heartbeat/--fleet-token/--fleet-shed-after/"
            "--chaos-spec require --actors N (the in-process schedules "
            "have no fleet wire; docs/TOPOLOGY.md)"
        ),
        match="require --actors",
        argv=("--fleet-wire", "bf16"),
    ),
    # -------------------------------------------------------- autoscaler
    Refusal(
        key="autoscale-without-actors",
        when=lambda a, np: bool(a.autoscale and not a.actors),
        reason=(
            "--autoscale 1 requires --actors N: the policy loop actuates "
            "the fleet supervisor's population, which the in-process "
            "schedules do not spawn (docs/TOPOLOGY.md)"
        ),
        match="requires --actors",
        argv=("--autoscale", "1"),
    ),
    Refusal(
        key="autoscale-knobs-without-autoscale",
        when=lambda a, np: bool(not a.autoscale and _autoscale_only_knobs(a)),
        reason=(
            "--autoscale-dry-run/--autoscale-min/--autoscale-max/"
            "--autoscale-cooldown/--autoscale-every/--autoscale-fire "
            "require --autoscale 1 (without the policy loop they would "
            "silently configure nothing; docs/TOPOLOGY.md)"
        ),
        match="require --autoscale",
        argv=("--actors", "2", "--autoscale-dry-run", "1"),
    ),
    # ------------------------------------------------------ replay shards
    Refusal(
        key="shards-without-actors",
        when=lambda a, np: bool(
            not a.actors and a.replay_shards and a.replay_shards > 1
        ),
        reason=(
            "--replay-shards N >= 2 requires --actors N (replay shards "
            "are fed by actor SEQS traffic; --replay-shards 1 --actors 0 "
            "routes the untouched phase-locked loop — the determinism "
            "anchor; docs/TOPOLOGY.md)"
        ),
        match="requires --actors",
        argv=("--replay-shards", "2"),
    ),
    Refusal(
        key="shards-x-drain-coalesce",
        when=lambda a, np: bool(a.replay_shards and a.drain_coalesce != 1),
        reason=(
            "--replay-shards does not compose with --drain-coalesce: "
            "there is no central drain to coalesce on the sampler path "
            "(docs/TOPOLOGY.md)"
        ),
        match="does not compose",
        argv=("--actors", "2", "--replay-shards", "2",
              "--drain-coalesce", "4"),
    ),
    # ------------------------------------------------- standalone shards
    Refusal(
        key="shard-procs-without-sampler-path",
        when=lambda a, np: bool(
            a.shard_procs and not (a.actors and a.replay_shards)
        ),
        reason=(
            "--shard-procs N requires --actors N --replay-shards M: the "
            "standalone shard tier hosts the sampler path's replay "
            "shards, which are fed by actor SEQS traffic "
            "(--shard-procs 0 is the in-learner loopback — the pinned "
            "off-setting; docs/TOPOLOGY.md)"
        ),
        match="requires --actors",
        argv=("--shard-procs", "2"),
    ),
    Refusal(
        key="shard-chaos-without-shard-procs",
        when=lambda a, np: _chaos_shard_faults(a),
        reason=(
            "--chaos-spec shard-tier faults (kill_shard/stall_shard/"
            "partition_shard) drill the standalone shard processes and "
            "require --shard-procs N: the in-learner loopback shards "
            "share the learner's failure domain, so there is no shard to "
            "kill, stall, or partition independently (docs/TOPOLOGY.md)"
        ),
        match="shard-procs",
        argv=("--actors", "2", "--replay-shards", "2",
              "--chaos-spec", "kill_shard@p2"),
    ),
    # ---------------------------------------------- direct data plane
    Refusal(
        key="shard-direct-without-sampler-path",
        when=lambda a, np: bool(
            a.shard_direct and not (a.actors and a.replay_shards)
        ),
        reason=(
            "--shard-direct 1 requires --actors N --replay-shards M: the "
            "direct data plane routes actor SEQS traffic to the sampler "
            "path's replay shards (--shard-direct 0 is the "
            "learner-forwarded path — the pinned off-setting; "
            "docs/TOPOLOGY.md)"
        ),
        match="requires --actors",
        argv=("--shard-direct", "1"),
    ),
    Refusal(
        key="sampler-knobs-without-shards",
        when=lambda a, np: bool(not a.replay_shards and _sampler_pull_knobs(a)),
        reason=(
            "--shard-pullers/--shard-prefetch require --replay-shards N: "
            "the concurrent pullers and the batch prefetch belong to the "
            "sampler learner's pull loop, which the central-drain and "
            "in-process schedules do not run (docs/TOPOLOGY.md)"
        ),
        match="require --replay-shards",
        argv=("--shard-pullers", "2"),
    ),
    Refusal(
        key="data-plane-chaos-without-shard-direct",
        when=lambda a, np: _chaos_direct_faults(a),
        reason=(
            "--chaos-spec partition_data_plane drills the direct "
            "actor->shard data leg and requires --shard-direct 1: with "
            "the experience riding the learner-forwarded path there is "
            "no data plane to partition, so the drill would record "
            "evidence for a recovery path that never ran "
            "(docs/TOPOLOGY.md)"
        ),
        match="shard-direct",
        argv=("--actors", "2", "--replay-shards", "2",
              "--chaos-spec", "partition_data_plane@p2"),
    ),
    # ------------------------------------------------------- dp learner
    Refusal(
        key="learner-dp-x-spmd",
        when=lambda a, np: bool(a.learner_dp and a.spmd),
        reason=(
            "--learner-dp does not compose with --spmd: two mesh owners "
            "(pjit-style dp learner vs shard_map whole-phase trainer; "
            "docs/TOPOLOGY.md)"
        ),
        match="does not compose",
        argv=("--learner-dp", "2", "--spmd", "2"),
    ),
    Refusal(
        key="learner-dp-x-pipeline",
        when=lambda a, np: bool(a.learner_dp and a.pipeline),
        reason=(
            "--learner-dp does not compose with --pipeline 1: the "
            "pipelined executor's staging path is not mesh-placed "
            "(docs/TOPOLOGY.md)"
        ),
        match="does not compose",
        argv=("--learner-dp", "2", "--pipeline", "1"),
    ),
    # ------------------------------------------------------ chaos drills
    Refusal(
        key="learner-dp-x-overlap-learner",
        when=lambda a, np: bool(a.learner_dp and a.overlap_learner),
        reason=(
            "--learner-dp does not compose with --overlap-learner 1: the "
            "interleaved-update schedule belongs to the host-pool trainer "
            "(docs/TOPOLOGY.md)"
        ),
        match="does not compose",
        argv=("--learner-dp", "2", "--overlap-learner", "1"),
    ),
    Refusal(
        key="sampler-chaos-without-shards",
        when=lambda a, np: _chaos_sampler_faults(a),
        reason=(
            "--chaos-spec sampler-class faults (stall_sampler/"
            "kill_sampler_conn) drill the in-network sampler peer class "
            "and require --replay-shards N: on the central drain they "
            "would stall the DRAIN thread while recording evidence for an "
            "invariant that path cannot exhibit (docs/TOPOLOGY.md)"
        ),
        match="replay-shards",
        argv=("--actors", "2", "--chaos-spec", "stall_sampler@p2:1s"),
    ),
    # -------------------------------------------------------- obs / trace
    Refusal(
        key="trace-without-staging-path",
        when=lambda a, np: bool(
            a.trace_sample and not (a.actors or a.pipeline)
        ),
        reason=(
            "--trace-sample requires --actors N or --pipeline 1 (the "
            "phase-locked fused schedule has no staging path to trace; "
            "docs/TOPOLOGY.md)"
        ),
        match="requires --actors N or --pipeline",
        argv=("--trace-sample", "0.5"),
    ),
    Refusal(
        key="obs-fleet-without-fleet",
        when=lambda a, np: bool(a.obs_fleet and not a.actors and np == 1),
        reason=(
            "--obs-fleet requires --actors N or a multi-process run (a "
            "single process already scrapes itself on --obs-port; "
            "docs/TOPOLOGY.md)"
        ),
        match="requires --actors",
        argv=("--obs-fleet", "1"),
    ),
    Refusal(
        key="obs-fleet-x-pipeline-multiprocess",
        when=lambda a, np: bool(a.obs_fleet and a.pipeline and np > 1),
        reason=(
            "--obs-fleet with --pipeline 1 is not wired on multi-process "
            "runs (the registry allgather rides the fused schedule's log "
            "cadence) — drop --pipeline or --obs-fleet (docs/TOPOLOGY.md)"
        ),
        match="not wired on multi-process",
        argv=("--obs-fleet", "1", "--pipeline", "1", "--spmd", "2"),
        processes=2,
    ),
    # ------------------------------------------------- the port's own row
    Refusal(
        key="multiprocess-not-yet-ported",
        when=lambda a, np: bool(np > 1 and a.pipeline),
        reason=(
            "--pipeline 1 is not ported to multi-process runs yet: its "
            "collector and learner threads would both call collectives on "
            "one process group, which needs a cross-rank order that is not "
            "ported; run it at world size 1"
        ),
        match="not ported to multi-process",
        argv=("--spmd", "2", "--pipeline", "1"),
        processes=2,
    ),
)


# -------------------------------------------------------------- validation


def _mesh_size(args) -> int:
    return int(args.spmd or args.learner_dp or 0)


def validate(args, process_count: int = 1) -> Topology:
    """Value checks + the refusal table -> the resolved Topology.

    Raises SystemExit with the table row's reason on the first refused
    pairing.  ``process_count`` is the run's world size: ``--spmd D`` and
    ``--learner-dp D`` need D processes, one device each."""
    if args.replay_shards and args.replay_shards < 1:
        raise SystemExit("--replay-shards must be >= 1 (0 = off)")
    if args.shard_procs < 0:
        raise SystemExit("--shard-procs must be >= 0 (0 = in-learner loopback)")
    if args.shard_procs and args.replay_shards and args.replay_shards % args.shard_procs:
        raise SystemExit(
            f"--shard-procs: {args.replay_shards} replay shards not "
            f"divisible by {args.shard_procs} shard processes (contiguous "
            f"equal slices per process)"
        )
    if args.shard_pullers < 0:
        raise SystemExit(
            "--shard-pullers must be >= 0 (0 = one puller per shard, "
            "capped at 8)"
        )
    if args.shard_prefetch < 0:
        raise SystemExit("--shard-prefetch must be >= 0 (0 = off)")
    if args.learner_dp and args.learner_dp < 1:
        raise SystemExit("--learner-dp must be >= 1 (0 = off)")
    if args.spmd and args.spmd < 1:
        raise SystemExit("--spmd must be >= 1 (0 = off)")
    if args.autoscale:
        if args.autoscale_cooldown <= 0:
            raise SystemExit("--autoscale-cooldown must be > 0 seconds")
        if args.autoscale_every <= 0:
            raise SystemExit("--autoscale-every must be > 0 seconds")
        if args.autoscale_fire < 1:
            raise SystemExit("--autoscale-fire must be >= 1")
        # Bounds are judged against --actors; without it the pairing row
        # (autoscale-without-actors) below is the authority.
        if args.actors:
            amin = args.autoscale_min
            amax = args.autoscale_max or args.actors
            if amin < 1:
                raise SystemExit("--autoscale-min must be >= 1")
            if amax < amin:
                raise SystemExit(
                    f"--autoscale-max ({amax}) must be >= --autoscale-min "
                    f"({amin})"
                )
            if args.actors > amax:
                raise SystemExit(
                    f"--autoscale-max ({amax}) must be >= --actors "
                    f"({args.actors}): the startup population must fit "
                    f"the sigma-ladder bound the autoscaler enforces"
                )
    if args.fleet_heartbeat is not None and args.fleet_heartbeat <= 0:
        raise SystemExit("--fleet-heartbeat must be > 0 seconds")
    if not 0.0 <= args.trace_sample <= 1.0:
        raise SystemExit("--trace-sample must be in [0, 1]")
    if args.chaos_spec:
        # A malformed schedule is refused before anything is spawned.
        try:
            parse_chaos_spec(args.chaos_spec)
        except ValueError as e:
            raise SystemExit(f"--chaos-spec: {e}")
    for rule in REFUSALS:
        if rule.when(args, process_count):
            raise SystemExit(rule.reason)
    # One process per device: the mesh is the world (after the pairings,
    # which name the user's real conflict first).
    d = _mesh_size(args)
    if (d or process_count > 1) and d != process_count:
        flag = "--spmd" if args.spmd else "--learner-dp"
        want = d or process_count
        raise SystemExit(
            f"{flag} {d}: this run has {process_count} process(es), one "
            f"device each; a mesh of {want} needs {want} processes: "
            f"torchrun --nproc-per-node {want} -m r2d2dpg_torch.train ... "
            f"{flag} {want}"
        )
    return resolve(args)


# ---------------------------------------------------------------- assembly


def build_trainer(topo: Topology, cfg, device=None, make_mesh=None):
    """Assemble the learn-stage trainer the topology names on ``device``
    (``cuda`` by default; each rank's own card under torchrun).

    ``make_mesh`` defaults to ``parallel.make_mesh`` (injectable for
    tests)."""
    if topo.learn in ("spmd_mesh", "dp_mesh") and make_mesh is None:
        from r2d2dpg_torch.parallel import make_mesh
    if topo.learn == "spmd_mesh":
        try:
            return cfg.build_spmd(make_mesh(topo.spmd, device))
        except ValueError as e:
            raise SystemExit(f"--spmd: {e}")
    if topo.learn == "dp_mesh":
        try:
            return cfg.build_dp_learner(
                make_mesh(topo.learner_dp, device),
                collect_local=topo.collect == "local",
            )
        except ValueError as e:
            # Mesh wider than the world, indivisible capacity/batch: refuse
            # at startup.
            raise SystemExit(f"--learner-dp: {e}")
    return cfg.build(device)


def build_fleet_learner(topo: Topology, trainer, fleet_config,
                        replay_capacity=None, shard_set=None):
    """The ingest+sample+learn composition of a fleet run:
    ``sharded_rings``/``two_level`` -> ``SamplerLearner`` (pull loop),
    ``central_drain``/``arena`` -> ``FleetLearner`` (drain loop).  Both
    compose with a dp-mesh trainer (the staged and pulled batches go
    through ``Trainer._put_staged``).  ``shard_set`` (the standalone tier's
    ``RemoteShardSet``) moves the sampler path's shards out of process;
    ``None`` keeps the in-learner loopback."""
    if topo.sample == "two_level":
        from r2d2dpg_torch.fleet.sampler import SamplerLearner

        try:
            return SamplerLearner(
                trainer,
                fleet_config,
                num_shards=topo.replay_shards,
                total_capacity=replay_capacity,
                shard_set=shard_set,
            )
        except ValueError as e:
            raise SystemExit(f"--replay-shards: {e}")
    from r2d2dpg_torch.fleet.ingest import FleetLearner

    return FleetLearner(trainer, fleet_config)
