"""Actor fleet: supervised out-of-process actors feeding the learner.

Port of the single-learner path of ``r2d2dpg_tpu/fleet/`` (the Ape-X
topology, PAPERS.md 1803.00933).  N actor subprocesses each own their env
lanes and a stale net copy, rank fresh sequences locally, and stream
``replay.StagedSequences`` over a CRC-checked framed protocol to the
learner's ingest server, which drains them through the pipelined
executor's drain body into the replay arena.  ``--actors 0`` is the
untouched phase-locked schedule.

- ``transport``  -- length-prefixed CRC32 frames over TCP/Unix sockets,
  HELLO authentication, ``to_host`` (one batched device-to-host copy).
- ``wire``       -- the zero-copy SEQS/PARAMS payload codec, byte-equal to
  the JAX package's (f32 and bf16 lanes, zlib/zstd, sampler frames).
- ``actor``      -- the worker-process collect loop and the per-actor slice
  of the noise ladder (``python -m r2d2dpg_torch.fleet.actor``).
- ``ingest``     -- ``IngestServer`` (N connections -> staging queue) and
  ``FleetLearner`` (the queue's single consumer: drain -> add -> learn).
- ``supervisor`` -- spawn/monitor/restart-with-backoff of the actors and
  of the shard processes, and the runtime resize API (``retire_slot``,
  ``set_target``, ``restart="policy"``).
- ``sampler``    -- in-network experience sampling (``--replay-shards N``):
  replay shards at the ingest edge, ``SamplerLearner`` pulls ``[K, B]``
  batches through SAMPLE_REQ/BATCH frames and writes PRIO back.
- ``shard``      -- the standalone shard tier (``--shard-procs N``): shard
  processes, ``RemoteShardSet`` (reroute, renormalization, epoch-fenced
  rejoin) and ``ShardProcTier`` (``python -m r2d2dpg_torch.fleet.shard``);
  with ``--shard-direct`` the actors dial their shard themselves.
- ``chaos``      -- seeded fault drills at the fleet's real boundaries
  (SIGKILL, stall, byte flip, socket close, partition), ``--chaos-spec``.
- ``autoscaler`` -- the health -> actuation loop (``--autoscale``): health
  findings become spawn/replace/retire actions on the supervisors.

With ``--obs-fleet`` the actors and the shard processes push their
registry snapshots as TELEM frames, which the learner folds into its
``/metrics`` scrape under ``actor=``/``shard=`` and ``host=`` labels.
"""

from r2d2dpg_torch.fleet.actor import (
    FleetActor,
    FleetActorTrainer,
    actor_seed,
    build_actor_trainer,
    structural_argv,
)
from r2d2dpg_torch.fleet.autoscaler import (
    AutoscaleConfig,
    Autoscaler,
    ScaleAction,
)
from r2d2dpg_torch.fleet.chaos import ChaosEngine, Fault, parse_chaos_spec
from r2d2dpg_torch.fleet.ingest import (
    FleetConfig,
    FleetLearner,
    IngestServer,
    load_fleet_counters,
    pack_host,
    prune_fleet_counters,
    put_staged,
    save_fleet_counters,
    snapshot_params,
)
from r2d2dpg_torch.fleet.sampler import SamplerLearner, ShardSet, shard_for_actor
from r2d2dpg_torch.fleet.shard import (
    RemoteShard,
    RemoteShardSet,
    ShardProcTier,
    ShardServer,
    ShardUnavailableError,
)
from r2d2dpg_torch.fleet.supervisor import (
    ActorSupervisor,
    SupervisorConfig,
    default_actor_argv,
)
from r2d2dpg_torch.fleet.wire import WireConfig

__all__ = [
    "ActorSupervisor",
    "AutoscaleConfig",
    "Autoscaler",
    "ChaosEngine",
    "Fault",
    "FleetActor",
    "FleetActorTrainer",
    "FleetConfig",
    "FleetLearner",
    "IngestServer",
    "RemoteShard",
    "RemoteShardSet",
    "SamplerLearner",
    "ScaleAction",
    "ShardProcTier",
    "ShardServer",
    "ShardSet",
    "ShardUnavailableError",
    "SupervisorConfig",
    "WireConfig",
    "actor_seed",
    "build_actor_trainer",
    "default_actor_argv",
    "load_fleet_counters",
    "pack_host",
    "parse_chaos_spec",
    "prune_fleet_counters",
    "put_staged",
    "save_fleet_counters",
    "shard_for_actor",
    "snapshot_params",
    "structural_argv",
]
