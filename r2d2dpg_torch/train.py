"""Training CLI of the port (a subset of ``python -m r2d2dpg_tpu.train``).

    python -m r2d2dpg_torch.train --config pendulum_r2d2 --phases 100 \
        [--log-every 10] [--seed 0] [--device cpu] [--logdir DIR] \
        [--checkpoint-dir D [--checkpoint-every N] [--checkpoint-light]] \
        [--resume] [--eval-every N [--eval-envs E]] \
        [--twin-critic 1] [--target-policy-sigma 0.2] \
        [--compute-dtype bfloat16] [--n-step 3] [--actor-lr 1e-4] \
        [--critic-lr 1e-3] [--sigma-max 0.4] [--ladder-alpha 7] \
        [--pipeline 1 [--pipeline-depth 2] [--trace-sample 0.1]] \
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
import sys

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
    p.add_argument(
        "--pipeline", type=int, default=0, choices=[0, 1],
        help="run train phases through the pipelined collect/learn "
        "executor (training/pipeline.py): collection and learning overlap "
        "in two threads over a bounded staging queue (1 = on)")
    p.add_argument(
        "--pipeline-depth", type=int, default=2,
        help="staging-queue capacity in collect phases (backpressure bound)")
    p.add_argument(
        "--trace-sample", type=float, default=0.0, metavar="RATE",
        help="experience-path tracing: sample this fraction of staged "
        "batches and record per-hop spans (collect -> enqueue -> arena_add "
        "-> learn) into r2d2dpg_trace_*_seconds histograms and a "
        "Chrome-trace/Perfetto trace.json next to flight.jsonl (0 = off)")
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
    """The flags given on the command line, written into ``cfg``."""
    t = {f: getattr(args, f) for f in ("seed", "sigma_max", "ladder_alpha")}
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
    return cfg


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


def main(argv=None) -> TrainerState:
    """Run the CLI; returns the final trainer state."""
    args = parse_args(argv)
    cfg = _apply_overrides(get_config(args.config), args)
    if args.resume and not args.checkpoint_dir:
        raise SystemExit("--resume requires --checkpoint-dir")
    trainer = cfg.build(args.device)
    print(f"backend: {device_name(trainer.device)}", flush=True)
    ckpt = None
    if args.checkpoint_dir:
        ckpt = CheckpointManager(
            args.checkpoint_dir,
            save_every=args.checkpoint_every,
            light=args.checkpoint_light,
        )
    if args.resume:
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

    if args.pipeline:
        try:
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
