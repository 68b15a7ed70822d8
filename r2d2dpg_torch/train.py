"""Training CLI of the port (a subset of ``python -m r2d2dpg_tpu.train``).

    python -m r2d2dpg_torch.train --config pendulum_r2d2 --phases 100 \
        [--log-every 10] [--seed 0] [--device cpu] \
        [--twin-critic 1] [--target-policy-sigma 0.2] \
        [--compute-dtype bfloat16] [--n-step 3] [--actor-lr 1e-4] \
        [--critic-lr 1e-3] [--sigma-max 0.4] [--ladder-alpha 7]

``--phases N`` counts TRAIN phases, as in the JAX CLI: a run does the
config's warm-up and replay-fill phases, then N train phases (one when
``--phases`` is absent).  Every ``--log-every`` phases it prints the same
line as the JAX ``Trainer.run``.  The run is on ``cuda`` unless
``--device cpu`` is given, and fails without a card.  The hyperparameter
overrides mean what they mean in the JAX CLI (``_apply_overrides``).
Flags outside this subset are not accepted yet.
"""

from __future__ import annotations

import argparse
import dataclasses

from r2d2dpg_torch.configs import CONFIGS, ExperimentConfig, get_config
from r2d2dpg_torch.device import device_name
from r2d2dpg_torch.training.trainer import TrainerState


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m r2d2dpg_torch.train", description=__doc__)
    p.add_argument("--config", required=True, choices=sorted(CONFIGS))
    p.add_argument("--phases", type=int, default=None, help="train phases to run")
    p.add_argument("--log-every", type=int, default=50, help="phases between logs")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
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
    trainer = cfg.build(args.device)
    print(f"backend: {device_name(trainer.device)}", flush=True)
    fill = trainer.window_fill_phases + trainer.replay_fill_phases
    num_phases = fill + (1 if args.phases is None else args.phases)
    return trainer.run(
        num_phases,
        log_every=args.log_every,
        log_fn=lambda line: print(line, flush=True),
    )


if __name__ == "__main__":
    main()
