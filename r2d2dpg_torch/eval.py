"""Evaluation CLI of the port (``python -m r2d2dpg_tpu.eval``'s flags).

    python -m r2d2dpg_torch.eval --config pendulum_r2d2 --checkpoint-dir D \\
        [--episodes 10] [--rounds 1] [--seed 0] [--compute-dtype bfloat16] \\
        [--twin-critic 1] [--device cpu]

Restores the learner subtree of the latest checkpoint under ``D`` (only
its ``train`` file is read, never the arena) and rolls ``--episodes``
noise-free episodes per round, printing one JSON line per round and a
summary line.  ``--twin-critic 1`` must match a checkpoint trained with
twin critics (the critic tree gains a ``[2]`` axis).  The port's bf16 and
float32 nets share one param tree, so ``--compute-dtype`` only chooses how
the policy computes.  Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from r2d2dpg_torch.configs import CONFIGS, get_config
from r2d2dpg_torch.training.draws import Draws
from r2d2dpg_torch.training.evaluator import Evaluator
from r2d2dpg_torch.utils.checkpoint import restore_subtree


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m r2d2dpg_torch.eval", description=__doc__)
    p.add_argument("--config", required=True, choices=sorted(CONFIGS))
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--episodes", type=int, default=10, help="eval episodes (one env each)")
    p.add_argument("--rounds", type=int, default=1, help="repeat with fresh draws")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute-dtype", default=None, choices=["float32", "bfloat16"])
    p.add_argument("--twin-critic", type=int, default=None, choices=[0, 1],
                   help="set when the checkpoint was trained with --twin-critic 1")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg = get_config(args.config)
    if args.compute_dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=args.compute_dtype)
    if args.twin_critic is not None:
        cfg = dataclasses.replace(
            cfg, agent=dataclasses.replace(cfg.agent, twin_critic=bool(args.twin_critic))
        )
    trainer = cfg.build(args.device)
    # The learner's tree on the meta device: shapes and dtypes, no storage.
    template = trainer.agent.init(torch.Generator().manual_seed(0), "meta")
    out, ckpt_step = restore_subtree(
        args.checkpoint_dir, {"train": template}, device=trainer.device,
        hint="learner tree: wrong --twin-critic or config for this checkpoint?",
    )
    train = out["train"]
    evaluator = Evaluator(
        cfg.env_factory(trainer.device), trainer.agent.actor, num_envs=args.episodes
    )
    draws = Draws(args.seed, trainer.device)
    means = []
    for r in range(args.rounds):
        res = evaluator.run(train.actor_params, draws)
        means.append(res["eval_return_mean"])
        print(json.dumps({"round": r, "learner_step": train.step, **res}), flush=True)
    summary = {
        "learner_step": train.step,
        "checkpoint_step": ckpt_step,
        "rounds": args.rounds,
        "episodes_per_round": args.episodes,
        "eval_return_mean": sum(means) / len(means),
    }
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
