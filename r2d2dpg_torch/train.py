"""Training CLI of the port (a subset of ``python -m r2d2dpg_tpu.train``).

    python -m r2d2dpg_torch.train --config pendulum_r2d2 --phases 100 \
        [--log-every 10] [--seed 0] [--device cpu]

``--phases N`` counts TRAIN phases, as in the JAX CLI: a run does the
config's warm-up and replay-fill phases, then N train phases (one when
``--phases`` is absent).  Every ``--log-every`` phases it prints the same
line as the JAX ``Trainer.run``.  The run is on ``cuda`` unless
``--device cpu`` is given, and fails without a card.  Flags outside this
subset are not accepted yet.
"""

from __future__ import annotations

import argparse
import dataclasses

from r2d2dpg_torch.configs import CONFIGS, get_config
from r2d2dpg_torch.device import device_name
from r2d2dpg_torch.training.trainer import TrainerState


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m r2d2dpg_torch.train", description=__doc__)
    p.add_argument("--config", required=True, choices=sorted(CONFIGS))
    p.add_argument("--phases", type=int, default=None, help="train phases to run")
    p.add_argument("--log-every", type=int, default=50, help="phases between logs")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    return p.parse_args(argv)


def main(argv=None) -> TrainerState:
    """Run the CLI; returns the final trainer state."""
    args = parse_args(argv)
    cfg = get_config(args.config)
    if args.seed is not None:
        cfg = dataclasses.replace(
            cfg, trainer=dataclasses.replace(cfg.trainer, seed=args.seed)
        )
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
