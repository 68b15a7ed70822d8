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
          [--shard-prefetch 1] [--shard-direct 1]] [--chaos-spec SPEC] \
         [--obs-fleet 1] [--autoscale 1 [--autoscale-dry-run 1] \
          [--autoscale-min N] [--autoscale-max N] [--autoscale-cooldown S] \
          [--autoscale-every S] [--autoscale-fire K]]] \
        [--spmd D | --learner-dp D] \
        [--minutes M] [--watchdog 0|1] [--watchdog-grad-norm X] \
        [--watchdog-param-norm X] [--nan-inject-phase K] [--nan-debug] \
        [--obs-port P [--obs-host H]] [--flight-path F] \
        [--health-wait-p99 S] [--health-stale-after S] [--quality-max-lag N] \
        [--device-peak-flops F] [--profile-window P:N | --profile-phases N]

Every run resolves through ``topology.py``: ``validate`` refuses the
pairings the port does not run (one table, JAX's messages), the run prints
``topology: <describe()>`` and writes it to ``<logdir>/topology.txt``.
``--spmd D`` (``parallel/spmd.py``) and ``--learner-dp D``
(``parallel/dp_learner.py``) run over a D-process ``torch.distributed``
group, one device each: ``--spmd 1`` / ``--learner-dp 1`` bring up a group
of one in this process; D > 1 runs under ``torchrun --nproc-per-node D -m
r2d2dpg_torch.train ...`` (a D that differs from ``WORLD_SIZE`` refuses).
Logs, the CSV, the exporter and flight dumps are rank 0's.  With
``--obs-fleet 1`` on a multi-process run every rank's registry folds into
rank 0's scrape under ``host=proc<i>``.  Rank 0 decides what host state
decides (``parallel/control.py``): the ``--minutes`` deadline, and under
``--actors N`` the whole fleet (ingest, supervisors, drain or pull loop),
which the other ranks follow.  A checkpoint of a mesh run is its global
state, saved by every rank and written by rank 0; ``--eval-every`` runs
on rank 0, then every rank meets at one barrier.

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
arena_add, learn) into ``<logdir>/trace.json``.  With a DM-Control config
under ``--spmd D`` it runs over the host-pool trainer in a world of D
ranks: every rank runs the executor (its collector calls no collective),
rank 0 prints, logs and writes the trace and the final checkpoint (the
global state), and every rank meets at a barrier after that save.

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
phase-locked loop.  ``--shard-direct 1`` splits the planes: each ingest
ack advertises the actor's shard and address, the actor ships SEQS to its
shard itself and sends only a K_STATS frame of accounting to the learner
(without ``--shard-procs`` there is no dialable shard and the actors keep
forwarding).

``--chaos-spec SPEC`` (``fleet/chaos.py``, e.g.
``kill_actor@p5,stall_actor@p12:2s``) runs seeded fault drills at the
fleet's real boundaries: the learner fires its faults on the drain or
pull clock, the actors and shard processes (the spec is forwarded) fire
theirs.  Each injection is a ``chaos_inject`` flight event and a
``r2d2dpg_fleet_chaos_drills_total{fault}`` count; a fault that never
fired is a ``chaos_unfired`` event and a warning at the end.

``--obs-fleet 1`` (with ``--actors``) spawns the actors, and the shard
processes, with ``--telem-every 1.0``: their registry snapshots fold into
this process's ``/metrics`` under ``actor=``/``shard=`` and ``host=``
labels, with per-process staleness gauges, and ``/health`` arms its
``telem_stale`` rule.  ``--autoscale 1`` (with ``--actors``) runs the
policy loop of ``fleet/autoscaler.py`` over the in-process health engine:
crashed actors stay down (``restart="policy"``) until the loop replaces
them, a silent actor is replaced, and the population moves between
``--autoscale-min`` and ``--autoscale-max`` on the load rules, gated by
``--autoscale-fire`` consecutive evaluations every ``--autoscale-every``
seconds and ``--autoscale-cooldown`` seconds between actions.  The actors'
sigma ladder spans ``max(--actors, --autoscale-max)`` lanes.
``--autoscale-dry-run 1`` decides without acting (the ladder keeps
restarting).  The ``fleet:`` line then carries ``autoscale_actions``,
``autoscale_decisions`` and ``autoscale_target``.

Telemetry (``obs/``): ``--obs-port P`` serves the process registry over
HTTP (``/metrics``, ``/metrics.json``, ``/health``, ``/healthz``; 0 binds an
ephemeral port, printed on an ``obs:`` line and written to
``<logdir>/obs_port.txt``), with the ``/health`` engine armed with the
run's thresholds (``--health-wait-p99``, ``--health-stale-after``,
``--quality-max-lag``) and its spawn targets; the CSV then carries the
registry's scalars as extra columns.  ``--device-peak-flops F`` is the
denominator of ``r2d2dpg_device_mfu`` (0 = unknown: the gauge stays 0).
``--profile-window P:N`` captures train/drain phases P..P+N-1 of whichever
loop runs with ``torch.profiler`` into ``<logdir>/profile_window/``
(``--profile-phases N``: the first N train phases of the phase-locked loop
into ``<logdir>/profile``; the two exclude each other).  The flight ring
dumps to ``--flight-path`` (default ``<logdir>/flight.jsonl``) at exit.
Under ``--actors`` a run with ``--logdir`` stamps ``metrics_final.prom``,
``health_final.json`` and ``quality_final.json`` before its supervisors
stop.  ``--nan-debug`` turns on autograd anomaly detection with NaN checks.

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
import contextlib
import dataclasses
import json
import os
import shutil
import sys
import tempfile

import torch

from r2d2dpg_torch import obs, topology
from r2d2dpg_torch.configs import CONFIGS, ExperimentConfig, get_config
from r2d2dpg_torch.device import device_name
from r2d2dpg_torch.fleet.chaos import parse_chaos_spec
from r2d2dpg_torch.parallel import distributed
from r2d2dpg_torch.parallel.control import control_plane
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
from r2d2dpg_torch.utils.profiling import nan_debug, profile_trace


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
        "--overlap-learner", type=int, default=None, choices=[0, 1],
        help="host-pool trainers: interleave learner updates between env "
        "steps so they hide under the MuJoCo step (1 = on)")
    # Multi-device learner paths (parallel/): one process per device.
    p.add_argument(
        "--spmd", type=int, default=0, metavar="D",
        help="run every rank's whole loop on its 1/D of the envs and the "
        "replay arena over a D-process dp mesh (parallel/spmd.py; "
        "gradients averaged over torch.distributed).  --spmd 1 runs in "
        "this process; D > 1 under torchrun --nproc-per-node D.  0 = "
        "single device")
    p.add_argument(
        "--learner-dp", type=int, default=0, metavar="D",
        help="data-parallel LEARNER over a D-process dp mesh "
        "(parallel/dp_learner.py): replay arena split into capacity "
        "blocks, learner batch split per rank, params replicated, the "
        "priority scatter on every rank's block.  Composes with --actors N "
        "(rank 0 runs the ingest and the drain or pull loop, every rank "
        "learns) and with --actors 0; --learner-dp 1 is pinned "
        "bit-identical to the plain schedule.  D > 1 under torchrun "
        "--nproc-per-node D (gloo with --device cpu).  0 = off")
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
        "--shard-direct", type=int, default=0, choices=[0, 1],
        help="1: the ingest ack advertises each actor's shard assignment "
        "(consistent-hash shard + its dialable address + epoch) and the "
        "actor ships SEQS straight to the shard — the learner wire "
        "carries only params/telem/accounting (a tiny K_STATS frame per "
        "phase), shedding the ingest forward hop from the experience "
        "path.  Requires --actors N --replay-shards M; with "
        "--shard-procs 0 there is no dialable tier, so actors stay on "
        "the learner-forwarded path (the documented fallback, also "
        "taken loudly on any data-leg failure).  0 = learner-forwarded "
        "(pinned bit-identical)")
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
        "--chaos-spec", default=None, metavar="SPEC",
        help="seeded fault-injection schedule (fleet/chaos.py), e.g. "
        "'kill_actor@p3,stall_actor@p5:4s,corrupt_frame@p7,"
        "kill_ingest_conn@p9' — each fault fires once at its drain/actor "
        "phase, at a real boundary (SIGKILL, sleep, byte flip, socket "
        "close), and must recover through the documented path; every "
        "injection lands in flight.jsonl + "
        "r2d2dpg_fleet_chaos_drills_total")
    # Autoscaler: the health -> actuation policy loop over the supervisor.
    p.add_argument(
        "--autoscale", type=int, default=0, choices=[0, 1],
        help="close the health→actuation loop (fleet/autoscaler.py): a "
        "policy thread evaluates the in-process health engine and maps "
        "findings to hysteresis-gated spawn/kill/replace actions through "
        "the supervisor's runtime resize API; crashed actors are "
        "replaced by POLICY (SupervisorConfig restart='policy') instead "
        "of the reflexive backoff ladder.  0 = off (structurally inert; "
        "default)")
    p.add_argument(
        "--autoscale-dry-run", type=int, default=0, choices=[0, 1],
        help="walk the full decision path — streaks, cooldown, window "
        "budget — logging autoscale_decision events, but never actuate "
        "(the supervisor keeps its reflexive ladder)")
    p.add_argument(
        "--autoscale-min", type=int, default=1, metavar="N",
        help="scale-down floor on the actor population (default 1)")
    p.add_argument(
        "--autoscale-max", type=int, default=0, metavar="N",
        help="scale-up ceiling on the actor population; also the GLOBAL "
        "sigma-ladder width (actors spawn with --num-actors max so every "
        "mintable lane has its own exploration sigma).  0 = pinned to "
        "--actors (no scale-up; default)")
    p.add_argument(
        "--autoscale-cooldown", type=float, default=30.0, metavar="S",
        help="minimum seconds between landed autoscale actions (default "
        "30)")
    p.add_argument(
        "--autoscale-every", type=float, default=2.0, metavar="S",
        help="health-evaluation cadence of the policy loop (default 2)")
    p.add_argument(
        "--autoscale-fire", type=int, default=3, metavar="K",
        help="consecutive evaluations a health rule must fire before it "
        "may act (hysteresis; default 3)")
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
    p.add_argument("--nan-debug", action="store_true",
                   help="autograd anomaly detection with NaN checks (backward only)")
    p.add_argument(
        "--profile-phases", type=int, default=0,
        help="trace this many train phases into --logdir/profile")
    p.add_argument(
        "--profile-window", default=None, metavar="P:N",
        help="device-plane profiler capture (obs/device.py): run "
        "torch.profiler for N train/drain phases starting at phase P into "
        "<logdir>/profile_window, on WHICHEVER learner loop the run "
        "resolves to (phase-locked, pipelined, fleet drain, sampler "
        "pull).  profile_start/profile_stop flight events bracket the "
        "capture, and 'obs.flight merge --trace-out' stamps it as a "
        "labelled profile_window span in the fused Perfetto timeline.  "
        "Mutually exclusive with --profile-phases (one profiler session "
        "per process); requires --logdir")
    p.add_argument(
        "--device-peak-flops", type=float, default=0.0, metavar="FLOPS",
        help="the accelerator's peak FLOP/s for the r2d2dpg_device_mfu "
        "gauge (e.g. 6.7e13 for an H100 SXM at dense fp32).  0 = unknown: "
        "the gauge stays 0 rather than inventing a denominator")
    # Observability.
    p.add_argument(
        "--obs-port", type=int, default=None, metavar="PORT",
        help="serve the telemetry registry over HTTP: /metrics (Prometheus "
        "text) + /metrics.json (JSON snapshot); 0 binds an ephemeral port "
        "(resolved port printed and written to <logdir>/obs_port.txt)")
    p.add_argument(
        "--obs-host", default="0.0.0.0",
        help="interface the --obs-port exporter binds (127.0.0.1 = "
        "loopback-only on shared hosts)")
    p.add_argument(
        "--flight-path", default=None,
        help="flight-recorder dump path (default <logdir>/flight.jsonl, "
        "or ./flight.jsonl without --logdir); sampled trace spans dump "
        "to trace.json next to it")
    p.add_argument(
        "--obs-fleet", type=int, default=0, choices=[0, 1],
        help="fleet-wide metric aggregation: with --actors N, actors push "
        "~1 Hz TELEM registry snapshots that fold into this process's "
        "/metrics under actor=/host= labels (one scrape point per fleet, "
        "with per-actor staleness gauges); with --shard-procs N the "
        "standalone shard processes push the same TELEM over their "
        "authenticated learner legs (shard=/host= labels, per-shard "
        "staleness armed at HELLO and reset on epoch-bumped rejoin)")
    p.add_argument(
        "--health-wait-p99", type=float, default=0.5, metavar="S",
        help="/health 'learner_starving' threshold: learner/sampler wait "
        "p99 above this reads as the fleet failing to feed the learner")
    p.add_argument(
        "--health-stale-after", type=float, default=10.0, metavar="S",
        help="/health 'telem_stale' threshold: an actor's or shard's "
        "TELEM staleness above this reads as wedged/partitioned/dead")
    p.add_argument(
        "--quality-max-lag", type=float, default=100.0, metavar="N",
        help="/health 'stale_experience' threshold: policy-lag p99 "
        "(learner param version minus the behavior version stamped on "
        "trained sequences, obs/quality.py) above this reads as the "
        "learner training on stale experience")
    return p.parse_args(argv)


def _apply_overrides(cfg: ExperimentConfig, args) -> ExperimentConfig:
    """The flags given on the command line, written into ``cfg``; then
    ``--lr-scale-batch``'s rule on the resolved learning rates."""
    base_batch = cfg.trainer.batch_size
    t = {f: getattr(args, f) for f in (
        "num_envs", "batch_size", "learner_steps", "min_replay",
        "param_sync_every", "overlap_learner", "seed", "sigma_max", "ladder_alpha")}
    t = {k: v for k, v in t.items() if v is not None}
    if "overlap_learner" in t:
        t["overlap_learner"] = bool(t["overlap_learner"])
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


def _health_config(args) -> obs.HealthConfig:
    """The run's resolved /health thresholds and expected process counts,
    for both the exporter's engine and the fleet teardown's
    ``health_final.json`` (a default config expects 0 actors and 0 shard
    processes, which disarms actors_down/shards_down)."""
    return obs.HealthConfig(
        learner_wait_p99_s=args.health_wait_p99,
        telem_stale_after_s=args.health_stale_after,
        expected_actors=args.actors or 0,
        expected_shard_procs=args.shard_procs or 0,
        # Staleness clocks arm at HELLO regardless, but TELEM pushes ride
        # --obs-fleet only: without it a growing clock is configuration.
        telem_expected=bool(args.obs_fleet),
        quality_max_lag=args.quality_max_lag,
    )


def _poison_actor_params(train):
    """--nan-inject-phase: NaN in every actor param, so the next learner
    update's outputs go non-finite through the real propagation path."""
    return dataclasses.replace(train, actor_params={
        k: torch.full_like(v, float("nan")) for k, v in train.actor_params.items()})


def _abort_on_divergence(e, flight, flight_path, ckpt) -> None:
    """Watchdog trip: dump the flight ring (rank 0's), name the last
    checkpoint on disk, exit with code 2.  On a mesh every rank trips at
    the same phase (the metrics are mesh means) and exits 2."""
    flight.record("abort", reason=str(e), step=e.step)
    dumped = flight.dump(flight_path) if distributed.is_primary() else "rank 0's"
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


def _make_executor_metrics_fn(logger, watchdog, num_phases, say=print):
    """The pipelined executor's log hook: ``say`` the phase-locked loop's
    line, fold rates into the CSV row, and give the watchdog the raw
    (pre-rates) scalars."""

    def metrics_fn(phase: int, scalars) -> None:
        scalars = dict(scalars)
        watch = dict(scalars)
        learn = {k: v for k, v in scalars.items() if k not in (
            "episode_return_mean", "episodes", "env_steps", "learner_steps")}
        say(f"phase {phase}/{num_phases} "
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


def _fold_executor_stats(prefix: str, stats: dict, say=print) -> None:
    """Print an executor's end-of-run stats line."""
    if stats:
        say(f"{prefix}: " + " ".join(
            f"{k} {v:.4g}" for k, v in sorted(stats.items())), flush=True)


def _run_pipelined(trainer, state, stop_at, logger, ckpt, args, watchdog,
                   flight, flight_path) -> TrainerState:
    """Drive the run through the pipelined executor (``--pipeline 1``): it
    owns the warm-up -> fill -> train schedule and the log cadence; the
    final checkpoint is saved when a checkpoint dir is set.

    On a mesh every rank runs it; rank 0 alone prints, and writes the final
    checkpoint (the global state), after which every rank meets at a
    barrier, so a ``--resume`` that follows reads one step on every rank."""
    say = print if distributed.is_primary() else (lambda *a, **k: None)
    executor = PipelineExecutor(trainer, PipelineConfig(
        enabled=True, queue_depth=args.pipeline_depth,
        trace_sample=args.trace_sample))
    if ckpt is not None and ckpt.save_every > 0:
        # The state is split across two threads mid-run, so periodic saves
        # are not composed with the executor: degrade LOUDLY to -1.
        say("pipeline: periodic checkpoints not supported with --pipeline 1; "
            "saving the final checkpoint only (--checkpoint-every -1 "
            "semantics)", flush=True)
    if args.eval_every:
        say("pipeline: in-run evals (--eval-every) do not run under "
            "--pipeline 1", flush=True)
    hook = None
    if args.nan_inject_phase is not None:
        k_inject = args.nan_inject_phase

        def hook(n, train):
            return _poison_actor_params(train) if n == k_inject else train

    try:
        state = executor.run(
            stop_at, state=state, log_every=args.log_every,
            metrics_fn=_make_executor_metrics_fn(logger, watchdog, stop_at, say),
            minutes=args.minutes, learner_hook=hook)
        _fold_executor_stats("pipeline", executor.stats(), say)
        if ckpt is not None and ckpt.save_every:
            ckpt.save_final(state.phase_idx, state, trainer)
            mesh = getattr(trainer, "mesh", None)
            if mesh is not None:
                mesh.barrier()
    except DivergenceError as e:
        _abort_on_divergence(e, flight, flight_path, ckpt)
    finally:
        flight.dump_trace()  # no-op unless spans were sampled and a path is armed
    return state


def _run_fleet(cfg, topo, trainer, state, logger, ckpt, args, watchdog, flight,
               flight_path, replay_capacity) -> TrainerState:
    """Drive the run through the actor fleet (``--actors N``): this process
    is the learner; an ingest server feeds the staging queue (or, under
    ``--replay-shards``, the replay shards), a supervisor owns the actor
    subprocesses (and another the shard processes), and the drain or pull
    loop runs here.  ``--phases`` counts drain-learn (pull-learn) phases;
    ``replay_capacity`` is the config's capacity, which the shards own.

    On a dp mesh all of that is rank 0's; every other rank builds the same
    trainer and follows rank 0's control records (``parallel/control.py``).
    A ``--resume`` reads the same light checkpoint and counter sidecar on
    every rank, held equal across ranks before the first drain."""
    from r2d2dpg_torch.fleet import load_fleet_counters
    from r2d2dpg_torch.fleet.ingest import follow_drain
    from r2d2dpg_torch.fleet.sampler import follow_pull

    resume_from = None
    if args.resume:
        if ckpt.latest_step is None:
            raise SystemExit(f"--resume: no checkpoint found under {args.checkpoint_dir}")
        state = dataclasses.replace(state, train=ckpt.restore(state))
        resume_from = load_fleet_counters(args.checkpoint_dir, ckpt.latest_step)
        trainer._check_replicated(state, resume_from)
    if not distributed.is_primary():
        state = (follow_pull if args.replay_shards else follow_drain)(trainer, state)
    else:
        control = control_plane(trainer)
        # Rank 0 stopping anywhere (a refused flag, a dead supervisor) tells
        # the followers before it propagates.
        with control.leading() if control is not None else contextlib.nullcontext():
            state = _lead_fleet(cfg, topo, trainer, state, logger, ckpt, args, watchdog,
                                flight, flight_path, replay_capacity, resume_from)
    mesh = getattr(trainer, "mesh", None)
    if mesh is not None and ckpt is not None and ckpt.save_every:
        # Rank 0 writes the run's last checkpoint after the loop's STOP: no
        # rank leaves the run before it is on disk, so a --resume that
        # follows reads the same step on every rank.
        mesh.barrier()
    return state


def _lead_fleet(cfg, topo, trainer, state, logger, ckpt, args, watchdog, flight,
                flight_path, replay_capacity, resume_from) -> TrainerState:
    """``_run_fleet``'s learner: the ingest, the supervisors and the loop."""
    from r2d2dpg_torch.fleet import (
        ActorSupervisor,
        AutoscaleConfig,
        Autoscaler,
        ChaosEngine,
        FleetConfig,
        ShardProcTier,
        SupervisorConfig,
        WireConfig,
        default_actor_argv,
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
        shard_direct=bool(args.shard_direct),
    )
    faults = parse_chaos_spec(args.chaos_spec) if args.chaos_spec else ()
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
            chaos_spec=args.chaos_spec,
            flight_dir=args.logdir,
            # The shard processes join the --obs-fleet plane at the
            # actors' cadence.
            telem_every=1.0 if args.obs_fleet else 0.0,
        )
    try:
        learner = topology.build_fleet_learner(
            topo, trainer, fleet_config, replay_capacity=replay_capacity,
            shard_set=shard_tier.shard_set if shard_tier is not None else None)
    except SystemExit:
        if shard_dir is not None and not args.logdir:
            shutil.rmtree(shard_dir, ignore_errors=True)
        raise
    address = learner.start()
    print(f"fleet: ingest on {address}; spawning {args.actors} actors"
          + (f"; {args.replay_shards} replay shards (learner-pulled sampling"
             + (f", {args.shard_procs} standalone shard procs"
                if args.shard_procs else "") + ")"
             if args.replay_shards else ""), flush=True)
    if args.resume:
        step = ckpt.latest_step
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
    if args.obs_fleet:
        # The ~1 Hz TELEM cadence: every actor's registry lands in this
        # process's /metrics under actor=/host= labels.
        extra += ["--telem-every", "1.0"]
    if args.trace_sample and not args.replay_shards:
        # The sampler traces its own pull chain, so the actors' SEQS
        # sidecar would buy nothing there.
        extra += ["--trace-sample", str(args.trace_sample)]
    extra += ["--read-deadline", str(heartbeat_s)]
    if args.shard_direct:
        extra += ["--shard-direct", "1"]
    if args.chaos_spec:
        # The actors fire the actor-side faults that target them; the
        # engine below fires the rest, on the same seeded schedule.
        extra += ["--chaos-spec", args.chaos_spec]
    spawn_env = None
    if fleet_token:
        # Through the environment, NOT argv (visible in ps).
        spawn_env = dict(os.environ)
        spawn_env["R2D2DPG_FLEET_TOKEN"] = fleet_token

    # The global sigma-ladder width: every lane the autoscaler may mint
    # has its own sigma, and the chaos engine and the actors hash fault
    # targets over the same count.  Without --autoscale it is --actors.
    ladder_n = max(args.actors, args.autoscale_max if args.autoscale else 0)

    def argv_fn(i: int):
        argv = default_actor_argv(
            i, config_name=args.config, address=address,
            num_actors=ladder_n, seed=cfg.trainer.seed, extra=extra)
        if args.logdir:
            argv += ["--flight-path",
                     os.path.join(args.logdir, f"flight_actor{i}.jsonl")]
        return argv

    sup_config = SupervisorConfig()
    if args.autoscale and not args.autoscale_dry_run:
        # Crash recovery becomes a decision: the slot stays down for the
        # policy loop's spawn_slot (a dry run keeps the ladder).
        sup_config = dataclasses.replace(sup_config, restart="policy")
    supervisor = ActorSupervisor(
        argv_fn, args.actors, config=sup_config, env=spawn_env,
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
    engine = None
    if faults:
        engine = ChaosEngine(
            faults, seed=cfg.trainer.seed, num_actors=ladder_n,
            supervisor=supervisor, server=learner.server, shard_tier=shard_tier)
        run_kwargs["phase_fn"] = engine.on_phase
    autoscaler = None
    if args.autoscale:
        # The exporter's armed engine when --obs-port is up (the engine is
        # re-entrant), a private one otherwise.
        health_engine = getattr(obs.current_exporter(), "health", None)
        if health_engine is None:
            health_engine = obs.HealthEngine(
                _health_config(args), registry=obs.get_registry(),
                mirror=obs.get_remote_mirror())
        autoscaler = Autoscaler(
            health_engine, supervisor, shard_tier=shard_tier,
            config=AutoscaleConfig(
                min_actors=args.autoscale_min,
                max_actors=args.autoscale_max or args.actors,
                cooldown_s=args.autoscale_cooldown,
                eval_every_s=args.autoscale_every,
                fire_threshold=args.autoscale_fire,
                dry_run=bool(args.autoscale_dry_run)),
            ready_fn=lambda: learner.server.is_steady,
            expected_fn=learner.server.set_expected_actors)
    try:
        if shard_tier is not None:
            shard_tier.start()
        supervisor.start()
        if autoscaler is not None:
            autoscaler.start()
        state = learner.run(
            num_phases, state=state, log_every=args.log_every,
            metrics_fn=_make_executor_metrics_fn(logger, watchdog, num_phases),
            minutes=args.minutes, ckpt=ckpt,
            checkpoint_every=args.checkpoint_every, resume_from=resume_from,
            health_fn=health, **run_kwargs)
        health()
        stats = dict(learner.stats())
        stats["actor_restarts"] = float(supervisor.restarts_total)
        if autoscaler is not None:
            a_stats = autoscaler.stats()
            stats["autoscale_actions"] = float(
                sum(a_stats["autoscale_actions"].values()))
            stats["autoscale_decisions"] = float(a_stats["autoscale_decisions"])
            stats["autoscale_target"] = float(a_stats["autoscale_target"])
        if shard_tier is not None:
            stats["shard_restarts"] = float(shard_tier.restarts_total)
        for i in range(args.actors):
            first = learner.server.first_seqs_at.get(str(i))
            if first is not None:
                stats[f"actor{i}_first_seqs_s"] = first - supervisor.first_started_at(i)
        _fold_executor_stats("fleet", stats)
        if engine is not None and engine.unfired():
            # A drill that never got its phase must not read as one that
            # passed.
            names = [f"{f.kind}@p{f.phase}" for f in engine.unfired()]
            print("fleet: WARNING — chaos faults never fired (run too "
                  f"short?): {', '.join(names)}", flush=True)
            flight.record("chaos_unfired", faults=names)
        if ckpt is not None and ckpt.save_every:
            step = state.phase_idx
            ckpt.save_final(step, state)
            save_fleet_counters(ckpt.directory, step, learner.counters())
            prune_fleet_counters(ckpt.directory, ckpt.all_steps())
    except DivergenceError as e:
        _abort_on_divergence(e, flight, flight_path, ckpt)
    finally:
        if args.logdir:
            _stamp_final_evidence(args)
        # The autoscaler first of all: a tick racing the teardown would
        # read stopped supervisors as a fleet to repopulate.  Then the
        # supervisor: its stopping flag makes an actor's lost connection
        # an orderly exit, not a crash to restart.
        if autoscaler is not None:
            autoscaler.stop()
        supervisor.stop()
        if shard_tier is not None:
            shard_tier.stop()
        learner.close()
        if shard_dir is not None and not args.logdir:
            shutil.rmtree(shard_dir, ignore_errors=True)
        flight.dump_trace()  # no-op unless spans were sampled and a path is armed
    if faults and args.logdir:
        _warn_unfired_remote(faults, args, cfg.trainer.seed, flight)
    return state


def _warn_unfired_remote(faults, args, seed: int, flight) -> None:
    """The actor- and shard-side drills fire in other processes: after the
    teardown has flushed their flight dumps, a fault with no
    ``chaos_inject`` line there never fired."""
    from r2d2dpg_torch.fleet.chaos import (
        actor_faults_unfired,
        shard_faults_unfired,
    )

    missing = actor_faults_unfired(faults, args.logdir, seed=seed,
                                   num_actors=args.actors)
    if args.shard_procs:
        missing += shard_faults_unfired(faults, args.logdir, seed=seed,
                                        num_shard_procs=args.shard_procs)
    if missing:
        names = [f"{f.kind}@p{f.phase}" for f in missing]
        print("fleet: WARNING — actor/shard-side chaos faults left no "
              f"injection evidence in {args.logdir!r} (run too short? "
              f"target kept crashing?): {', '.join(names)}", flush=True)
        flight.record("chaos_unfired", faults=names)


def _arm_telemetry(args, flight, primary=True):
    """The device plane, the profiler window, the flight dump path and the
    exporter, as the JAX CLI arms them.  Returns ``(flight_path,
    exporter)``; the exporter is None without ``--obs-port`` and on every
    rank but 0, which also arm no flight dump."""
    device_mon = obs.get_device_monitor().install()
    device_mon.configure(peak_flops=args.device_peak_flops)
    if args.profile_window is not None:
        # Every rank captures its own window (files named by pid); rank 0 says so.
        pw_phase, pw_steps = device_mon.arm_profile(
            args.profile_window, os.path.join(args.logdir, "profile_window"))
        if primary:
            print(f"obs: profiler capture armed for phases "
                  f"{pw_phase}..{pw_phase + pw_steps - 1} -> "
                  f"{args.logdir}/profile_window", flush=True)
    flight_path = args.flight_path or (
        os.path.join(args.logdir, "flight.jsonl") if args.logdir else "flight.jsonl")
    if (args.logdir or args.flight_path) and primary:
        # The exit-time dump is armed only where the operator named a
        # destination; the watchdog's abort dumps either way.
        flight.install(flight_path)
    exporter = None
    if args.obs_port is not None and primary:
        registry = obs.get_registry()
        exporter = obs.start_exporter(args.obs_port, registry, args.obs_host)
        # Armed with this run's thresholds and spawn targets; the server is
        # already answering, and its lazy default must not win the race.
        exporter.arm_health(obs.HealthEngine(
            _health_config(args), registry=registry,
            mirror=obs.get_remote_mirror()))
        print(f"obs: /metrics + /metrics.json + /health on port {exporter.port}",
              flush=True)
        if args.logdir:
            os.makedirs(args.logdir, exist_ok=True)
            with open(os.path.join(args.logdir, "obs_port.txt"), "w") as f:
                f.write(f"{exporter.port}\n")
    return flight_path, exporter


def _stamp_final_evidence(args) -> None:
    """The fleet run's final merged scrape, /health verdict and quality
    plane into ``<logdir>``, written before the supervisors stop (a stopped
    supervisor reads 0 alive).  A failure prints a note and never raises:
    the teardown after it must run."""
    try:
        snap = obs.get_registry().snapshot()
        sources = obs.get_remote_mirror().sources()
        if sources:
            snap = obs.merge_remote(snap, sources)
        with open(os.path.join(args.logdir, "metrics_final.prom"), "w") as f:
            f.write(obs.render_prometheus(snap))
        engine = getattr(obs.current_exporter(), "health", None)
        if engine is None:
            # No exporter: judge with the run's config anyway (defaults
            # would disarm actors_down/shards_down).
            engine = obs.HealthEngine(
                _health_config(args), registry=obs.get_registry(),
                mirror=obs.get_remote_mirror())
        with open(os.path.join(args.logdir, "health_final.json"), "w") as f:
            json.dump(engine.evaluate(), f, default=str)
        with open(os.path.join(args.logdir, "quality_final.json"), "w") as f:
            json.dump(obs.get_quality_plane().snapshot_final(), f, default=str)
    except Exception as e:  # noqa: BLE001 - evidence is optional, teardown is not
        print(f"obs: final evidence stamp failed: {e!r}", flush=True)


def main(argv=None) -> TrainerState:
    """Run the CLI; returns the final trainer state."""
    args = parse_args(argv)
    # ONE validation authority: every refused pairing lives in
    # topology.REFUSALS with its reason.  The world size is torchrun's
    # (1 without it); the group itself comes up with the mesh below.
    world = int(os.environ.get("WORLD_SIZE", "1"))
    topo = topology.validate(args, process_count=world)
    if args.profile_window is not None:
        if args.profile_phases:
            raise SystemExit(
                "--profile-window and --profile-phases both drive the one "
                "profiler session this process has — pick one "
                "(--profile-window works on every learner loop and is "
                "the superset)")
        if not args.logdir:
            raise SystemExit("--profile-window requires --logdir")
        try:
            obs.device.parse_profile_window(args.profile_window)
        except ValueError as e:
            raise SystemExit(f"--profile-window: {e}")
    if args.nan_debug:
        nan_debug(True)
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
    trainer = topology.build_trainer(topo, cfg, args.device)
    primary = distributed.is_primary()
    # Side effects (log lines, CSV, exporter, flight dumps, topology.txt)
    # belong to rank 0; every rank runs the same collectives.
    say = print if primary else (lambda *a, **k: None)
    say(f"backend: {device_name(trainer.device)}", flush=True)
    say(f"topology: {topo.describe()}", flush=True)
    if args.logdir and primary:
        os.makedirs(args.logdir, exist_ok=True)
        with open(os.path.join(args.logdir, "topology.txt"), "w") as f:
            f.write(topo.describe() + "\n")
    ckpt = None
    if args.checkpoint_dir:
        light = args.checkpoint_light
        if args.actors and not light:
            # A fleet checkpoint is the learner subtree + counter sidecar;
            # the arena is re-absorbed from the actors on resume.
            say("fleet: checkpoints under --actors N are always light "
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
        say(f"resumed from phase {state.phase_idx} "
            f"(learner step {state.train.step})", flush=True)
    else:
        state = trainer.init()
    evaluator = None
    if args.eval_every and primary:
        # The params are replicated: rank 0 evaluates them for every rank.
        evaluator = Evaluator(
            cfg.env_factory(trainer.device), trainer.agent.actor, args.eval_envs
        )
        eval_draws = Draws(cfg.trainer.seed + 1, trainer.device)
    mesh = getattr(trainer, "mesh", None)
    flight = get_flight_recorder()
    flight_path, exporter = _arm_telemetry(args, flight, primary)
    logger = None
    if args.logdir and primary:
        logger = MetricLogger(
            args.logdir, registry=obs.get_registry() if exporter is not None else None)
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
                return _run_fleet(cfg, topo, trainer, state, logger, ckpt, args,
                                  watchdog, flight, flight_path, replay_capacity)
            return _run_pipelined(trainer, state, stop_at, logger, ckpt, args,
                                  watchdog, flight, flight_path)
        finally:
            if logger is not None:
                logger.close()

    # --profile-phases: a trace of the first N train phases of this run.
    profiler = {"cm": None, "until": None}

    def start_profile() -> None:
        if args.profile_phases and args.logdir and profiler["until"] is None:
            profiler["until"] = max(start, fill) + args.profile_phases
            profiler["cm"] = profile_trace(os.path.join(args.logdir, "profile"))
            profiler["cm"].__enter__()

    def stop_profile() -> None:
        if profiler["cm"] is not None:
            cm, profiler["cm"] = profiler["cm"], None
            cm.__exit__(None, None, None)

    if start >= fill:
        start_profile()

    def on_phase(state: TrainerState, scalars):
        phase = state.phase_idx
        if phase == fill and start < fill:
            start_profile()  # the next phase is the first train phase
        if profiler["until"] is not None and phase >= profiler["until"]:
            stop_profile()
        if scalars is not None:
            if args.obs_fleet and world > 1:
                # Collective (every rank logs on the same cadence): rank 0
                # folds the other ranks' registries into its mirror.
                obs.allgather_into_mirror()
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
            ckpt.maybe_save(phase, state, trainer)
        if args.eval_every and phase > fill and (phase - fill) % args.eval_every == 0:
            if evaluator is not None:
                ev = evaluator.run(state.train.actor_params, eval_draws)
                ev["env_steps"] = float(state.env_steps)
                print("eval " + json.dumps({"phase": phase, **ev}), flush=True)
                if logger is not None:
                    logger.log(phase, ev)
            if mesh is not None:
                # No rank enters the next phase's collectives while rank 0
                # evaluates.
                mesh.barrier()
        if (args.nan_inject_phase is not None
                and phase - max(start, fill) == args.nan_inject_phase):
            return dataclasses.replace(state, train=_poison_actor_params(state.train))
        return None

    try:
        state = trainer.run(
            stop_at,
            state,
            log_every=args.log_every,
            log_fn=lambda line: say(line, flush=True),
            on_phase=on_phase,
            minutes=args.minutes,
        )
        if ckpt is not None and ckpt.save_every:
            ckpt.save_final(state.phase_idx, state, trainer)
    except DivergenceError as e:
        _abort_on_divergence(e, flight, flight_path, ckpt)
    finally:
        stop_profile()
        if logger is not None:
            logger.close()
    return state


if __name__ == "__main__":
    main()
