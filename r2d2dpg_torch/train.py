"""Training CLI of the port (a subset of ``python -m r2d2dpg_tpu.train``).

    python -m r2d2dpg_torch.train --config pendulum_r2d2 --phases 100 \
        [--log-every 10] [--seed 0] [--device cpu] [--logdir DIR] \
        [--checkpoint-dir D [--checkpoint-every N] [--checkpoint-light]] \
        [--resume] [--eval-every N [--eval-envs E]] \
        [--twin-critic 1] [--target-policy-sigma 0.2] \
        [--compute-dtype bfloat16] [--n-step 3] [--actor-lr 1e-4] \
        [--critic-lr 1e-3] [--sigma-max 0.4] [--ladder-alpha 7] \
        [--num-envs E] [--batch-size B] [--learner-steps K] \
        [--min-replay N] [--param-sync-every K] [--lr-scale-batch 1] \
        [--pipeline 1 [--pipeline-depth 2] [--trace-sample 0.1]] \
        [--actors N [--fleet-address A] [--fleet-queue-depth Q] \
         [--fleet-publish-every P] [--fleet-idle-timeout S] \
         [--fleet-shed-after S] [--fleet-wire f32|bf16] \
         [--fleet-compress none|zlib|zstd] [--drain-coalesce K] \
         [--fleet-heartbeat S] [--fleet-token T] [--trace-sample R] \
         [--replay-shards M [--shard-procs P] [--shard-pullers N] \
          [--shard-prefetch 1]]] \
        [--minutes M] [--watchdog 0|1] [--watchdog-grad-norm X] \
        [--watchdog-param-norm X] [--nan-inject-phase K]

``--phases N`` counts TRAIN phases, as in the JAX CLI: a fresh run does
the config's warm-up and replay-fill phases, then N train phases (one when
``--phases`` is absent); a resumed run starts at the checkpoint's phase
and stops at ``max(start, fill) + N``.  Every ``--log-every`` phases it
prints the same line as the JAX ``Trainer.run`` (and, with ``--logdir``,
writes the scalars as a CSV row of ``<logdir>/metrics.csv``).

``--minutes`` bounds the wall clock as well (whichever of ``--phases`` and
``--minutes`` comes first).

``--pipeline 1`` runs the train phases through the pipelined collect/learn
executor (``training/pipeline.py``): a collector thread and the learner
overlap over a staging queue of ``--pipeline-depth`` phases, on two CUDA
streams on a card.  It saves the final checkpoint only (a periodic
``--checkpoint-every`` says so and falls back), runs no in-run evals, and
prints one ``pipeline:`` stats line at the end.  ``--trace-sample RATE``
records that share of its staged batches' hops (collect, enqueue,
arena_add, learn) into ``<logdir>/trace.json``.

``--actors N`` makes this process the learner of an actor fleet
(``fleet/``): an ingest server feeds a staging queue, a supervisor owns N
actor subprocesses on the CPU (spawned with ``--device cpu`` and no card
visible; restarted with backoff when they crash), and the drain loop runs
here: absorb to ``min_replay``, then ``--phases`` drain-learn phases, the
actors' parameters republished every ``--fleet-publish-every`` phases.
Checkpoints under ``--actors`` are always light, with a counter sidecar,
and ``--resume`` continues the counters.  It prints one ``fleet:`` stats
line at the end.  The wire and drain flags refuse to run without
``--actors``; ``--fleet-token`` defaults to ``$R2D2DPG_FLEET_TOKEN`` and
reaches the actors through their environment, never their argv.

``--replay-shards M`` (with ``--actors``) moves replay into M host-side
shards at the ingest edge (``fleet/sampler.py``): each actor's batches go
to its shard, and ``SamplerLearner`` pulls ``[K, B]`` batches through
SAMPLE_REQ/BATCH frames, learns on the card and writes the TD priorities
back in PRIO frames.  The shards own the config's capacity (split evenly,
which must divide); the trainer's device arena shrinks to
``max(num_envs, batch_size)`` slots, since nothing samples it.
``--shard-procs P`` hosts the M shards in P supervised shard processes
(``fleet/shard.py``, M % P == 0): a dead shard's quota renormalizes over
the survivors and it rejoins under a bumped epoch.  ``--shard-pullers N``
(0 = one per shard, at most 8; 1 = serial) and ``--shard-prefetch 1``
(the standalone tier only) shape the pull.  The ``fleet:`` line then also
carries ``sample_bytes_total``, ``trained_seqs_total``, ``evictions`` and
``shard_restarts``.  ``--replay-shards 1 --actors 0`` runs the untouched
phase-locked loop.

The divergence watchdog (``--watchdog 1``, the default) checks the learner
metrics on the log cadence of either schedule: a NaN/Inf, or a grad or
param norm past its threshold, dumps the flight recorder into
``<logdir>/flight.jsonl``, names the last checkpoint on disk, skips the
final save and exits with code 2.  ``--nan-inject-phase K`` poisons the
actor params after the K-th train phase (a drill of that path).

``--checkpoint-dir`` saves every ``--checkpoint-every`` phases (-1: the
final save only; 0: none) and at the end; ``--checkpoint-light`` saves the
learner only.  ``--resume`` continues from the latest checkpoint there.
``--eval-every N`` rolls ``--eval-envs`` noise-free episodes every N train
phases and prints one ``eval`` JSON line.  The run is on ``cuda`` unless
``--device cpu`` is given, and fails without a card.  The hyperparameter
overrides mean what they mean in the JAX CLI (``_apply_overrides``).
Flags outside this subset are not accepted yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile

import torch

from r2d2dpg_torch.configs import CONFIGS, ExperimentConfig, get_config
from r2d2dpg_torch.device import device_name
from r2d2dpg_torch.obs import (
    DivergenceError,
    DivergenceWatchdog,
    WatchdogConfig,
    get_flight_recorder,
)
from r2d2dpg_torch.training.draws import Draws
from r2d2dpg_torch.training.evaluator import Evaluator
from r2d2dpg_torch.training.pipeline import PipelineConfig, PipelineExecutor
from r2d2dpg_torch.training.trainer import TrainerState
from r2d2dpg_torch.utils.checkpoint import CheckpointManager, resume_state
from r2d2dpg_torch.utils.metrics import MetricLogger


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m r2d2dpg_torch.train", description=__doc__)
    p.add_argument("--config", required=True, choices=sorted(CONFIGS))
    p.add_argument("--phases", type=int, default=None, help="train phases to run")
    p.add_argument(
        "--minutes", type=float, default=None,
        help="wall-clock budget (stops at whichever of --phases/--minutes hits first)")
    p.add_argument("--log-every", type=int, default=50, help="phases between logs")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    p.add_argument("--logdir", default=None,
                   help="metrics CSV (+ TensorBoard when installed) and flight dump")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=500,
                   help="phases between checkpoints (0 = off; -1 = final save only)")
    p.add_argument("--checkpoint-light", action="store_true",
                   help="save the learner subtree only (resume restarts replay)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --checkpoint-dir")
    p.add_argument("--eval-every", type=int, default=0,
                   help="train phases between deterministic evals (0 = off)")
    p.add_argument("--eval-envs", type=int, default=10)
    # Agent/exploration hyperparameter overrides, as in the JAX CLI.
    p.add_argument("--sigma-max", type=float, default=None,
                   help="exploration noise ladder max sigma")
    p.add_argument("--ladder-alpha", type=float, default=None,
                   help="noise ladder spread exponent")
    p.add_argument("--n-step", type=int, default=None, help="n-step TD horizon")
    p.add_argument("--actor-lr", type=float, default=None)
    p.add_argument("--critic-lr", type=float, default=None)
    p.add_argument("--twin-critic", type=int, default=None, choices=[0, 1],
                   help="TD3 clipped double-Q: 2-critic ensemble, min bootstrap")
    p.add_argument("--target-policy-sigma", type=float, default=None,
                   help="TD3 target-policy smoothing noise scale (0 = off)")
    p.add_argument("--compute-dtype", default=None, choices=["float32", "bfloat16"],
                   help="net compute dtype (params/optimizer stay float32)")
    # Orchestration scale overrides, as in the JAX CLI.
    p.add_argument("--num-envs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument(
        "--lr-scale-batch", type=int, default=0, choices=[0, 1],
        help="scale actor/critic learning rates linearly with the batch "
        "size (PAPERS.md 1803.02811): the resolved lrs are multiplied by "
        "batch_size / <config default batch>, after --actor-lr/--critic-lr")
    p.add_argument("--learner-steps", type=int, default=None)
    p.add_argument("--min-replay", type=int, default=None)
    p.add_argument(
        "--param-sync-every", type=int, default=None,
        help="refresh behavior params every K phases (0 = always fresh)")
    p.add_argument(
        "--pipeline", type=int, default=0, choices=[0, 1],
        help="run train phases through the pipelined collect/learn "
        "executor (training/pipeline.py): collection and learning overlap "
        "in two threads over a bounded staging queue (1 = on)")
    p.add_argument(
        "--pipeline-depth", type=int, default=2,
        help="staging-queue capacity in collect phases (backpressure bound)")
    # Fleet mode: supervised out-of-process actors.
    p.add_argument(
        "--actors", type=int, default=0, metavar="N",
        help="spawn N supervised actor subprocesses streaming experience "
        "to a learner-side ingest server (0 = off: the in-process "
        "schedules, untouched)")
    p.add_argument(
        "--fleet-address", default="127.0.0.1:0",
        help="ingest server bind: 'host:port' (port 0 = ephemeral) or "
        "'unix:/path'")
    p.add_argument(
        "--fleet-queue-depth", type=int, default=4,
        help="staging-queue capacity in staged batches (past it the "
        "ingest server sheds loudly)")
    p.add_argument(
        "--fleet-publish-every", type=int, default=1,
        help="drain phases between versioned param publications to actors")
    p.add_argument(
        "--fleet-idle-timeout", type=float, default=300.0,
        help="seconds without a staged batch before the learner aborts as "
        "starved (the first batch gets double: actor spawn + start-up)")
    p.add_argument(
        "--fleet-shed-after", type=float, default=None, metavar="S",
        help="seconds a queue-full ingest handler waits before shedding a "
        "staged batch (past the startup grace; default 1.0)")
    p.add_argument(
        "--fleet-wire", default="f32", choices=["f32", "bf16"],
        help="payload precision on the fleet wire: f32 = bit-exact "
        "(default), bf16 = observations/carries/params at half the bytes "
        "(rewards/priorities stay f32; restored to f32 learner-side)")
    p.add_argument(
        "--fleet-compress", default="none", choices=["none", "zlib", "zstd"],
        help="fleet frame compression (zstd refused where the zstandard "
        "module is absent)")
    p.add_argument(
        "--drain-coalesce", type=int, default=1, metavar="K",
        help="stack up to K queue-backlogged staged batches into one "
        "drain (1 = one drain per batch; widths are powers of two <= K)")
    p.add_argument(
        "--replay-shards", type=int, default=0, metavar="N",
        help="shard prioritized replay across N ingest-edge shards "
        "(fleet/sampler.py): each actor's SEQS traffic feeds its shard, and "
        "the learner PULLS batches via SAMPLE_REQ/BATCH frames with quotas "
        "proportional to each shard's priority sum; TD priorities ride back "
        "as PRIO frames.  Requires --actors N (with --actors 0 only "
        "--replay-shards 1 is accepted and runs the untouched phase-locked "
        "loop).  0 = off (central drain)")
    p.add_argument(
        "--shard-procs", type=int, default=0, metavar="N",
        help="host the --replay-shards M shards in N supervised standalone "
        "shard processes (fleet/shard.py; M %% N == 0): a dead shard "
        "degrades sampling, never training, and rejoins empty under a "
        "bumped epoch.  0 = in-learner loopback")
    p.add_argument(
        "--shard-pullers", type=int, default=0, metavar="N",
        help="concurrent SAMPLE_REQ pullers over the replay shards (one "
        "in-flight request per live shard, up to N; the pulled batch is "
        "bitwise the serial loop's).  0 = one per shard, at most 8; 1 = "
        "serial")
    p.add_argument(
        "--shard-prefetch", type=int, default=0, choices=[0, 1],
        help="1: pull the next phase's batch while the current one trains "
        "(its priorities are one phase stale); standalone tier only.  0 = off")
    p.add_argument(
        "--fleet-heartbeat", type=float, default=None, metavar="S",
        help="liveness read deadline on both fleet wire ends (default "
        "300): a peer silent past it is PINGed once and reaped on a "
        "second silence")
    p.add_argument(
        "--fleet-token", default=None,
        help="shared HELLO-authentication secret; defaults to "
        "$R2D2DPG_FLEET_TOKEN (prefer the variable: an argv secret is "
        "readable in ps) and reaches spawned actors through their "
        "environment, never their command line")
    p.add_argument(
        "--trace-sample", type=float, default=0.0, metavar="RATE",
        help="experience-path tracing: sample this fraction of staged "
        "batches and record per-hop spans into r2d2dpg_trace_*_seconds "
        "histograms and a Chrome-trace/Perfetto trace.json next to "
        "flight.jsonl (0 = off); --pipeline 1 records collect -> enqueue "
        "-> arena_add -> learn, --actors N the 8 wire hops")
    p.add_argument(
        "--watchdog", type=int, default=1, choices=[0, 1],
        help="divergence watchdog on the log cadence: NaN/Inf or norm "
        "blow-up in learner outputs aborts loudly with a flight-recorder "
        "dump and a last-good-checkpoint pointer (1 = on)")
    p.add_argument("--watchdog-grad-norm", type=float, default=1e6,
                   help="watchdog trip threshold for grad_norm")
    p.add_argument("--watchdog-param-norm", type=float, default=1e7,
                   help="watchdog trip threshold for param_norm")
    p.add_argument(
        "--nan-inject-phase", type=int, default=None, metavar="K",
        help="FAULT INJECTION (tests/drills): poison the actor params with "
        "NaN after the K-th train phase, so the next learner update "
        "produces non-finite outputs and the watchdog path is exercised "
        "end to end")
    return p.parse_args(argv)


def _apply_overrides(cfg: ExperimentConfig, args) -> ExperimentConfig:
    """The flags given on the command line, written into ``cfg``; then
    ``--lr-scale-batch``'s rule on the resolved learning rates."""
    base_batch = cfg.trainer.batch_size
    t = {f: getattr(args, f) for f in (
        "num_envs", "batch_size", "learner_steps", "min_replay",
        "param_sync_every", "seed", "sigma_max", "ladder_alpha")}
    t = {k: v for k, v in t.items() if v is not None}
    if t:
        cfg = dataclasses.replace(cfg, trainer=dataclasses.replace(cfg.trainer, **t))
    a = {f: getattr(args, f)
         for f in ("n_step", "actor_lr", "critic_lr", "target_policy_sigma")}
    a = {k: v for k, v in a.items() if v is not None}
    if args.twin_critic is not None:
        a["twin_critic"] = bool(args.twin_critic)
    if a:
        cfg = dataclasses.replace(cfg, agent=dataclasses.replace(cfg.agent, **a))
    if args.compute_dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=args.compute_dtype)
    if args.lr_scale_batch:
        scale = cfg.trainer.batch_size / base_batch
        cfg = dataclasses.replace(cfg, agent=dataclasses.replace(
            cfg.agent, actor_lr=cfg.agent.actor_lr * scale,
            critic_lr=cfg.agent.critic_lr * scale))
        print(f"lr-scale-batch: linear rule (1803.02811) batch {base_batch} -> "
              f"{cfg.trainer.batch_size}, scale {scale:g} (actor_lr "
              f"{cfg.agent.actor_lr:g}, critic_lr {cfg.agent.critic_lr:g})",
              flush=True)
    return cfg


def _fleet_only_knobs(args) -> bool:
    return (
        args.fleet_wire != "f32"
        or args.fleet_compress != "none"
        or args.drain_coalesce != 1
        or args.fleet_token is not None
        or args.fleet_heartbeat is not None
        or args.fleet_shed_after is not None
    )


def _refuse(args) -> None:
    """The JAX CLI's refusals (``r2d2dpg_tpu/topology.py``: ``validate``
    and its ``REFUSALS`` rows) for the flags the port has, with the same
    messages."""
    if args.replay_shards and args.replay_shards < 1:
        raise SystemExit("--replay-shards must be >= 1 (0 = off)")
    if args.shard_procs < 0:
        raise SystemExit("--shard-procs must be >= 0 (0 = in-learner loopback)")
    if args.shard_procs and args.replay_shards and args.replay_shards % args.shard_procs:
        raise SystemExit(
            f"--shard-procs: {args.replay_shards} replay shards not "
            f"divisible by {args.shard_procs} shard processes (contiguous "
            f"equal slices per process)")
    if args.shard_pullers < 0:
        raise SystemExit(
            "--shard-pullers must be >= 0 (0 = one puller per shard, "
            "capped at 8)")
    if args.fleet_heartbeat is not None and args.fleet_heartbeat <= 0:
        raise SystemExit("--fleet-heartbeat must be > 0 seconds")
    if not 0.0 <= args.trace_sample <= 1.0:
        raise SystemExit("--trace-sample must be in [0, 1]")
    if args.actors and args.pipeline:
        raise SystemExit(
            "--actors N does not compose with --pipeline 1: both executors "
            "own the phase loop (docs/TOPOLOGY.md)")
    if args.actors and args.eval_every:
        raise SystemExit(
            "--actors N does not compose with --eval-every: the fleet "
            "learner owns the phase loop; run the final-checkpoint eval "
            "instead (docs/TOPOLOGY.md)")
    if args.actors and args.nan_inject_phase is not None:
        raise SystemExit(
            "--actors N does not compose with --nan-inject-phase: the "
            "poison targets the in-process collect loop actors own "
            "(docs/TOPOLOGY.md)")
    if not args.actors and _fleet_only_knobs(args):
        raise SystemExit(
            "--fleet-wire/--fleet-compress/--drain-coalesce/"
            "--fleet-heartbeat/--fleet-token/--fleet-shed-after "
            "require --actors N (the in-process schedules have no fleet "
            "wire; docs/TOPOLOGY.md)")
    if not args.actors and args.replay_shards and args.replay_shards > 1:
        raise SystemExit(
            "--replay-shards N >= 2 requires --actors N (replay shards "
            "are fed by actor SEQS traffic; --replay-shards 1 --actors 0 "
            "routes the untouched phase-locked loop — the determinism "
            "anchor; docs/TOPOLOGY.md)")
    if args.replay_shards and args.drain_coalesce != 1:
        raise SystemExit(
            "--replay-shards does not compose with --drain-coalesce: "
            "there is no central drain to coalesce on the sampler path "
            "(docs/TOPOLOGY.md)")
    if args.shard_procs and not (args.actors and args.replay_shards):
        raise SystemExit(
            "--shard-procs N requires --actors N --replay-shards M: the "
            "standalone shard tier hosts the sampler path's replay "
            "shards, which are fed by actor SEQS traffic "
            "(--shard-procs 0 is the in-learner loopback — the pinned "
            "off-setting; docs/TOPOLOGY.md)")
    if not args.replay_shards and (args.shard_pullers or args.shard_prefetch):
        raise SystemExit(
            "--shard-pullers/--shard-prefetch require --replay-shards N: "
            "the concurrent pullers and the batch prefetch belong to the "
            "sampler learner's pull loop, which the central-drain and "
            "in-process schedules do not run (docs/TOPOLOGY.md)")
    if args.trace_sample and not (args.actors or args.pipeline):
        raise SystemExit(
            "--trace-sample requires --actors N or --pipeline 1 (the "
            "phase-locked fused schedule has no staging path to trace; "
            "docs/TOPOLOGY.md)")


def _poison_actor_params(train):
    """--nan-inject-phase: NaN in every actor param, so the next learner
    update's outputs go non-finite through the real propagation path."""
    return dataclasses.replace(train, actor_params={
        k: torch.full_like(v, float("nan")) for k, v in train.actor_params.items()})


def _abort_on_divergence(e, flight, flight_path, ckpt) -> None:
    """Watchdog trip: dump the flight ring, name the last checkpoint on
    disk, exit with code 2."""
    flight.record("abort", reason=str(e), step=e.step)
    dumped = flight.dump(flight_path) if flight_path else None
    if ckpt is not None and ckpt.latest_step is not None:
        # The watchdog reads learner outputs once per log cadence, so a
        # save inside the last cadence may already carry the divergence.
        pointer = (f"{ckpt.directory} step {ckpt.latest_step} (verify before "
                   "resuming: a save inside the last log cadence may already "
                   "carry the divergence)")
    else:
        pointer = "none on disk"
    print(f"watchdog: DIVERGENCE at step {e.step}: {e.reason}\n"
          f"watchdog: flight recorder dumped to {dumped}\n"
          f"watchdog: last-good checkpoint: {pointer}",
          file=sys.stderr, flush=True)
    raise SystemExit(2)


def _make_executor_metrics_fn(logger, watchdog, num_phases):
    """The pipelined executor's log hook: print the phase-locked loop's
    line, fold rates into the CSV row, and give the watchdog the raw
    (pre-rates) scalars."""

    def metrics_fn(phase: int, scalars) -> None:
        scalars = dict(scalars)
        watch = dict(scalars)
        learn = {k: v for k, v in scalars.items() if k not in (
            "episode_return_mean", "episodes", "env_steps", "learner_steps")}
        print(f"phase {phase}/{num_phases} "
              f"env_steps {int(scalars['env_steps'])} "
              f"return {scalars['episode_return_mean']:.1f} "
              f"({int(scalars['episodes'])} eps) "
              + " ".join(f"{k} {v:.3g}" for k, v in learn.items()), flush=True)
        if logger is not None:
            scalars.update(logger.rates(
                env_steps=scalars.get("env_steps", 0.0),
                learner_steps=scalars.get("learner_steps", 0.0)))
            logger.log(phase, scalars)
        if watchdog is not None:
            watchdog.check(phase, watch)

    return metrics_fn


def _fold_executor_stats(prefix: str, stats: dict) -> None:
    """Print an executor's end-of-run stats line."""
    if stats:
        print(f"{prefix}: " + " ".join(
            f"{k} {v:.4g}" for k, v in sorted(stats.items())), flush=True)


def _run_pipelined(trainer, state, stop_at, logger, ckpt, args, watchdog,
                   flight, flight_path) -> TrainerState:
    """Drive the run through the pipelined executor (``--pipeline 1``): it
    owns the warm-up -> fill -> train schedule and the log cadence; the
    final checkpoint is saved when a checkpoint dir is set."""
    executor = PipelineExecutor(trainer, PipelineConfig(
        enabled=True, queue_depth=args.pipeline_depth,
        trace_sample=args.trace_sample))
    if ckpt is not None and ckpt.save_every > 0:
        # The state is split across two threads mid-run, so periodic saves
        # are not composed with the executor: degrade LOUDLY to -1.
        print("pipeline: periodic checkpoints not supported with --pipeline 1; "
              "saving the final checkpoint only (--checkpoint-every -1 "
              "semantics)", flush=True)
    if args.eval_every:
        print("pipeline: in-run evals (--eval-every) do not run under "
              "--pipeline 1", flush=True)
    hook = None
    if args.nan_inject_phase is not None:
        k_inject = args.nan_inject_phase

        def hook(n, train):
            return _poison_actor_params(train) if n == k_inject else train

    try:
        state = executor.run(
            stop_at, state=state, log_every=args.log_every,
            metrics_fn=_make_executor_metrics_fn(logger, watchdog, stop_at),
            minutes=args.minutes, learner_hook=hook)
        _fold_executor_stats("pipeline", executor.stats())
        if ckpt is not None and ckpt.save_every:
            ckpt.save_final(state.phase_idx, state)
    except DivergenceError as e:
        _abort_on_divergence(e, flight, flight_path, ckpt)
    finally:
        flight.dump_trace()  # no-op unless spans were sampled and a path is armed
    return state


def _run_fleet(cfg, trainer, state, logger, ckpt, args, watchdog, flight,
               flight_path, replay_capacity) -> TrainerState:
    """Drive the run through the actor fleet (``--actors N``): this process
    is the learner; an ingest server feeds the staging queue (or, under
    ``--replay-shards``, the replay shards), a supervisor owns the actor
    subprocesses (and another the shard processes), and the drain or pull
    loop runs here.  ``--phases`` counts drain-learn (pull-learn) phases;
    ``replay_capacity`` is the config's capacity, which the shards own."""
    from r2d2dpg_torch.fleet import (
        ActorSupervisor,
        FleetConfig,
        FleetLearner,
        SamplerLearner,
        ShardProcTier,
        WireConfig,
        default_actor_argv,
        load_fleet_counters,
        prune_fleet_counters,
        save_fleet_counters,
        structural_argv,
    )
    from r2d2dpg_torch.fleet import transport as fleet_transport

    try:
        wire_config = WireConfig(
            encoding=args.fleet_wire, compress=args.fleet_compress).validate()
    except ValueError as e:
        # e.g. zstd without the zstandard module: refused at startup, not
        # with a crash-looping fleet.
        raise SystemExit(f"--fleet-compress: {e}")
    fleet_token = args.fleet_token or os.environ.get("R2D2DPG_FLEET_TOKEN") or None
    if not fleet_transport.is_loopback_address(args.fleet_address) and not fleet_token:
        print(f"fleet: WARNING: binding routable address {args.fleet_address!r} "
              "WITHOUT --fleet-token: any host that can reach this port can "
              "stream experience into training", flush=True)
        flight.record("fleet_unauthenticated_bind", address=args.fleet_address)
    heartbeat_s = (args.fleet_heartbeat if args.fleet_heartbeat is not None
                   else fleet_transport.READ_DEADLINE_S)
    if args.resume and ckpt.latest_step is None:
        raise SystemExit(f"--resume: no checkpoint found under {args.checkpoint_dir}")
    fleet_config = FleetConfig(
        num_actors=args.actors,
        address=args.fleet_address,
        queue_depth=args.fleet_queue_depth,
        publish_every=args.fleet_publish_every,
        idle_timeout_s=args.fleet_idle_timeout,
        shed_after_s=(args.fleet_shed_after
                      if args.fleet_shed_after is not None else 1.0),
        wire=wire_config,
        drain_coalesce=args.drain_coalesce,
        heartbeat_s=heartbeat_s,
        auth_token=fleet_token,
        shard_pullers=args.shard_pullers,
        shard_prefetch=args.shard_prefetch,
    )
    # The standalone tier's processes are spawned inside the try below,
    # beside the actor supervisor: an early SystemExit must not orphan them.
    shard_tier, shard_dir = None, None
    if args.shard_procs:
        if args.logdir:
            shard_dir = os.path.join(args.logdir, "shards")
        else:
            shard_dir = tempfile.mkdtemp(prefix="r2d2dpg_shards_")
        shard_tier = ShardProcTier(
            num_shards=args.replay_shards,
            num_procs=args.shard_procs,
            capacity_per_shard=replay_capacity // args.replay_shards,
            alpha=cfg.trainer.priority_alpha,
            prioritized=cfg.trainer.prioritized,
            dirpath=shard_dir,
            seed=cfg.trainer.seed,
            wire_config=wire_config,
            auth_token=fleet_token,
            heartbeat_s=heartbeat_s,
            flight_dir=args.logdir,
        )
    if args.replay_shards:
        try:
            learner = SamplerLearner(
                trainer, fleet_config, num_shards=args.replay_shards,
                total_capacity=replay_capacity,
                shard_set=shard_tier.shard_set if shard_tier is not None else None)
        except ValueError as e:
            if shard_dir is not None and not args.logdir:
                shutil.rmtree(shard_dir, ignore_errors=True)
            raise SystemExit(f"--replay-shards: {e}")
    else:
        learner = FleetLearner(trainer, fleet_config)
    address = learner.start()
    print(f"fleet: ingest on {address}; spawning {args.actors} actors"
          + (f"; {args.replay_shards} replay shards (learner-pulled sampling"
             + (f", {args.shard_procs} standalone shard procs"
                if args.shard_procs else "") + ")"
             if args.replay_shards else ""), flush=True)
    resume_from = None
    if args.resume:
        step = ckpt.latest_step
        state = dataclasses.replace(state, train=ckpt.restore(state))
        resume_from = load_fleet_counters(args.checkpoint_dir, step)
        if not resume_from:
            print(f"fleet: WARNING: checkpoint step {step} has no counter "
                  "sidecar; counters restart at 0", flush=True)
        print(f"fleet: resumed learner from step {step} (drained "
              f"{int(resume_from.get('drained', 0))} phases, env_steps "
              f"{resume_from.get('env_steps_total', 0.0):.0f})", flush=True)
    # The actors mirror the learner's RESOLVED structure, ladder and wire.
    extra = structural_argv(cfg) + [
        "--wire", args.fleet_wire,
        "--compress", args.fleet_compress,
        "--max-frame-bytes", str(fleet_transport.MAX_FRAME_BYTES),
    ]
    if args.trace_sample and not args.replay_shards:
        # The sampler traces its own pull chain, so the actors' SEQS
        # sidecar would buy nothing there.
        extra += ["--trace-sample", str(args.trace_sample)]
    extra += ["--read-deadline", str(heartbeat_s)]
    spawn_env = None
    if fleet_token:
        # Through the environment, NOT argv (visible in ps).
        spawn_env = dict(os.environ)
        spawn_env["R2D2DPG_FLEET_TOKEN"] = fleet_token

    def argv_fn(i: int):
        argv = default_actor_argv(
            i, config_name=args.config, address=address,
            num_actors=args.actors, seed=cfg.trainer.seed, extra=extra)
        if args.logdir:
            argv += ["--flight-path",
                     os.path.join(args.logdir, f"flight_actor{i}.jsonl")]
        return argv

    supervisor = ActorSupervisor(
        argv_fn, args.actors, env=spawn_env,
        log_path_fn=((lambda i: os.path.join(args.logdir, f"actor{i}.log"))
                     if args.logdir else None))

    def health() -> None:
        gave = supervisor.gave_up()
        if gave:
            raise RuntimeError(
                f"fleet: the supervisor gave up actor(s) {gave} (restart "
                "budget spent or HELLO refused; see the flight recorder)")

    if args.phases is not None:
        num_phases = args.phases
    elif args.minutes is not None:
        num_phases = 10**9  # the wall-clock budget is the stop condition
    else:
        num_phases = 1
    run_kwargs = {"trace_sample": args.trace_sample} if args.replay_shards else {}
    try:
        if shard_tier is not None:
            shard_tier.start()
        supervisor.start()
        state = learner.run(
            num_phases, state=state, log_every=args.log_every,
            metrics_fn=_make_executor_metrics_fn(logger, watchdog, num_phases),
            minutes=args.minutes, ckpt=ckpt,
            checkpoint_every=args.checkpoint_every, resume_from=resume_from,
            health_fn=health, **run_kwargs)
        health()
        stats = dict(learner.stats())
        stats["actor_restarts"] = float(supervisor.restarts_total)
        if shard_tier is not None:
            stats["shard_restarts"] = float(shard_tier.restarts_total)
        for i in range(args.actors):
            first = learner.server.first_seqs_at.get(str(i))
            if first is not None:
                stats[f"actor{i}_first_seqs_s"] = first - supervisor.first_started_at(i)
        _fold_executor_stats("fleet", stats)
        if ckpt is not None and ckpt.save_every:
            step = state.phase_idx
            ckpt.save_final(step, state)
            save_fleet_counters(ckpt.directory, step, learner.counters())
            prune_fleet_counters(ckpt.directory, ckpt.all_steps())
    except DivergenceError as e:
        _abort_on_divergence(e, flight, flight_path, ckpt)
    finally:
        # The supervisor first: its stopping flag makes an actor's lost
        # connection an orderly exit, not a crash to restart.
        supervisor.stop()
        if shard_tier is not None:
            shard_tier.stop()
        learner.close()
        if shard_dir is not None and not args.logdir:
            shutil.rmtree(shard_dir, ignore_errors=True)
        flight.dump_trace()  # no-op unless spans were sampled and a path is armed
    return state


def main(argv=None) -> TrainerState:
    """Run the CLI; returns the final trainer state."""
    args = parse_args(argv)
    _refuse(args)
    if args.actors and args.replay_shards > args.actors:
        print(f"replay-shards: WARNING — {args.replay_shards} shards but only "
              f"{args.actors} actors: {args.replay_shards - args.actors} shards "
              f"will never receive traffic and effective replay capacity is "
              f"{args.actors}/{args.replay_shards} of the configured capacity",
              flush=True)
    cfg = _apply_overrides(get_config(args.config), args)
    if args.resume and not args.checkpoint_dir:
        raise SystemExit("--resume requires --checkpoint-dir")
    if args.replay_shards and not args.actors:
        print("replay-shards: no fleet (--actors 0) — replay stays in the "
              "central device arena and the phase-locked schedule runs "
              "unchanged (the determinism anchor)", flush=True)
    replay_capacity = cfg.trainer.capacity
    if args.replay_shards and args.actors:
        reachable = (replay_capacity // args.replay_shards) * min(
            args.actors, args.replay_shards)
        if cfg.trainer.min_replay > reachable:
            # Only min(actors, shards) shards ever receive traffic: an
            # unreachable absorb gate would starve a healthy fleet.
            raise SystemExit(
                f"--replay-shards: min_replay {cfg.trainer.min_replay} "
                f"exceeds the reachable shard occupancy {reachable} "
                f"({args.actors} actors feed min(actors, shards) of "
                f"{args.replay_shards} shards x "
                f"{replay_capacity // args.replay_shards} slots) — "
                f"lower --min-replay or --replay-shards")
        # The shards own the replay capacity; nothing samples the device
        # arena, so it shrinks to a token allocation.
        cfg = dataclasses.replace(cfg, trainer=dataclasses.replace(
            cfg.trainer,
            capacity=max(cfg.trainer.num_envs, cfg.trainer.batch_size)))
    trainer = cfg.build(args.device)
    print(f"backend: {device_name(trainer.device)}", flush=True)
    ckpt = None
    if args.checkpoint_dir:
        light = args.checkpoint_light
        if args.actors and not light:
            # A fleet checkpoint is the learner subtree + counter sidecar;
            # the arena is re-absorbed from the actors on resume.
            print("fleet: checkpoints under --actors N are always light "
                  "(learner subtree + counters; the arena is re-absorbed "
                  "on resume)", flush=True)
            light = True
        ckpt = CheckpointManager(
            args.checkpoint_dir,
            save_every=args.checkpoint_every,
            light=light,
        )
    if args.resume and not args.actors:
        state = resume_state(trainer, ckpt)
        print(f"resumed from phase {state.phase_idx} "
              f"(learner step {state.train.step})", flush=True)
    else:
        state = trainer.init()
    evaluator = None
    if args.eval_every:
        evaluator = Evaluator(
            cfg.env_factory(trainer.device), trainer.agent.actor, args.eval_envs
        )
        eval_draws = Draws(cfg.trainer.seed + 1, trainer.device)
    logger = None
    flight = get_flight_recorder()
    flight_path = None
    if args.logdir:
        logger = MetricLogger(args.logdir)
        flight_path = os.path.join(args.logdir, "flight.jsonl")
        flight.install(flight_path)
    watchdog = None
    if args.watchdog:
        watchdog = DivergenceWatchdog(WatchdogConfig(
            grad_norm_max=args.watchdog_grad_norm,
            param_norm_max=args.watchdog_param_norm))

    fill = trainer.window_fill_phases + trainer.replay_fill_phases
    start = state.phase_idx
    # --phases counts train phases of THIS invocation (the JAX CLI's rule).
    if args.phases is not None:
        stop_at = max(start, fill) + args.phases
    elif args.minutes is not None:
        stop_at = 10**9  # the wall-clock budget is the stop condition
    else:
        stop_at = max(start, fill + 1)

    if args.pipeline or args.actors:
        try:
            if args.actors:
                return _run_fleet(cfg, trainer, state, logger, ckpt, args,
                                  watchdog, flight, flight_path, replay_capacity)
            return _run_pipelined(trainer, state, stop_at, logger, ckpt, args,
                                  watchdog, flight, flight_path)
        finally:
            if logger is not None:
                logger.close()

    def on_phase(state: TrainerState, scalars):
        phase = state.phase_idx
        if scalars is not None:
            watch = dict(scalars)
            if logger is not None:
                scalars.update(logger.rates(
                    env_steps=scalars["env_steps"],
                    learner_steps=float(state.train.step)))
                logger.log(phase, scalars)
            if watchdog is not None:
                # After the log call, so the poisoned row is on disk.
                watchdog.check(phase, watch)
        if ckpt is not None:
            ckpt.maybe_save(phase, state)
        if evaluator is not None and phase > fill and (phase - fill) % args.eval_every == 0:
            ev = evaluator.run(state.train.actor_params, eval_draws)
            ev["env_steps"] = float(state.env_steps)
            print("eval " + json.dumps({"phase": phase, **ev}), flush=True)
            if logger is not None:
                logger.log(phase, ev)
        if (args.nan_inject_phase is not None
                and phase - max(start, fill) == args.nan_inject_phase):
            return dataclasses.replace(state, train=_poison_actor_params(state.train))
        return None

    try:
        state = trainer.run(
            stop_at,
            state,
            log_every=args.log_every,
            log_fn=lambda line: print(line, flush=True),
            on_phase=on_phase,
            minutes=args.minutes,
        )
        if ckpt is not None and ckpt.save_every:
            ckpt.save_final(state.phase_idx, state)
    except DivergenceError as e:
        _abort_on_divergence(e, flight, flight_path, ckpt)
    finally:
        if logger is not None:
            logger.close()
    return state


if __name__ == "__main__":
    main()
