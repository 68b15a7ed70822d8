"""Training CLI of the port (a subset of ``python -m r2d2dpg_tpu.train``).

    python -m r2d2dpg_torch.train --config pendulum_r2d2 --phases 100 \
        [--log-every 10] [--seed 0] [--device cpu] [--logdir DIR] \
        [--checkpoint-dir D [--checkpoint-every N] [--checkpoint-light]] \
        [--resume] [--eval-every N [--eval-envs E]] \
        [--twin-critic 1] [--target-policy-sigma 0.2] \
        [--compute-dtype bfloat16] [--n-step 3] [--actor-lr 1e-4] \
        [--critic-lr 1e-3] [--sigma-max 0.4] [--ladder-alpha 7]

``--phases N`` counts TRAIN phases, as in the JAX CLI: a fresh run does
the config's warm-up and replay-fill phases, then N train phases (one when
``--phases`` is absent); a resumed run starts at the checkpoint's phase
and stops at ``max(start, fill) + N``.  Every ``--log-every`` phases it
prints the same line as the JAX ``Trainer.run`` (and, with ``--logdir``,
writes the scalars as a CSV row of ``<logdir>/metrics.csv``).

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

from r2d2dpg_torch.configs import CONFIGS, ExperimentConfig, get_config
from r2d2dpg_torch.device import device_name
from r2d2dpg_torch.obs import get_flight_recorder
from r2d2dpg_torch.training.draws import Draws
from r2d2dpg_torch.training.evaluator import Evaluator
from r2d2dpg_torch.training.trainer import TrainerState
from r2d2dpg_torch.utils.checkpoint import CheckpointManager, resume_state
from r2d2dpg_torch.utils.metrics import MetricLogger


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m r2d2dpg_torch.train", description=__doc__)
    p.add_argument("--config", required=True, choices=sorted(CONFIGS))
    p.add_argument("--phases", type=int, default=None, help="train phases to run")
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
    if args.logdir:
        logger = MetricLogger(args.logdir)
        get_flight_recorder().install(os.path.join(args.logdir, "flight.jsonl"))

    fill = trainer.window_fill_phases + trainer.replay_fill_phases
    start = state.phase_idx
    # --phases counts train phases of THIS invocation (the JAX CLI's rule).
    stop_at = (
        max(start, fill) + args.phases if args.phases is not None
        else max(start, fill + 1)
    )

    def on_phase(state: TrainerState, scalars) -> None:
        phase = state.phase_idx
        if scalars is not None and logger is not None:
            scalars.update(logger.rates(
                env_steps=scalars["env_steps"], learner_steps=float(state.train.step)))
            logger.log(phase, scalars)
        if ckpt is not None:
            ckpt.maybe_save(phase, state)
        if evaluator is not None and phase > fill and (phase - fill) % args.eval_every == 0:
            ev = evaluator.run(state.train.actor_params, eval_draws)
            ev["env_steps"] = float(state.env_steps)
            print("eval " + json.dumps({"phase": phase, **ev}), flush=True)
            if logger is not None:
                logger.log(phase, ev)

    try:
        state = trainer.run(
            stop_at,
            state,
            log_every=args.log_every,
            log_fn=lambda line: print(line, flush=True),
            on_phase=on_phase,
        )
        if ckpt is not None and ckpt.save_every:
            ckpt.save_final(state.phase_idx, state)
    finally:
        if logger is not None:
            logger.close()
    return state


if __name__ == "__main__":
    main()
