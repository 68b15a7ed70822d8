#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s multi-device legs alone, with all their checks.

    python3 probes/mesh_legs.py

Run from the root of a checkout on a machine with a CUDA card (about four
minutes on an H100 host).  Builds the port's kernels, then runs, exactly as
``chip_smoke.py`` runs them (any failed check raises): ``learner_dp1``
(``DPLearnerTrainer`` at walker_r2d2's shapes on a world of one over NCCL,
beside the plain ``Trainer``), the plain ``pendulum_r2d2`` train run
``--phases 10 --log-every 16``, then ``spmd1`` and ``learner_dp1_cli``
(the same run with ``--spmd 1`` / ``--learner-dp 1``, bitwise on the plain
one), ``fleet_dp1`` (``--actors 2 --learner-dp 1 --phases 20``, through
rank 0's broadcast path), ``sampler_dp1`` (``--actors 2 --replay-shards 2
--learner-dp 1 --phases 10``; without the loopback leg of a whole
``chip_smoke.py`` run its rate has no neighbour) and ``mesh_lifecycle1``
(checkpoints, ``--resume`` and ``--eval-every`` with ``--learner-dp 1``
and ``--spmd 1``, bitwise on the uninterrupted run).  The first line is
the card's name and power limit; each leg prints its JSON record; the
last line gives each leg's scatter launches and seconds.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from r2d2dpg_torch import kernels, resolve_device  # noqa: E402


def _plain_run():
    from r2d2dpg_torch.train import main as train_main

    with contextlib.redirect_stdout(io.StringIO()):
        state = train_main(["--config", "pendulum_r2d2", "--phases", "10",
                            "--log-every", "16"])
    return {"train": copy.deepcopy(state.train),
            "priority": state.arena.priority.clone()}


def _torn_down(leg, *args):
    with cs._group_of_one():
        return leg(*args)


def main() -> int:
    if not torch.cuda.is_available():
        print("mesh_legs: no CUDA card available", file=sys.stderr)
        return 1
    dev = resolve_device("cuda")
    raw, name, limit = cs._card_line()
    print(raw, flush=True)
    kernels.build_all(kernels.ALL_KERNELS)
    for k in kernels.ALL_KERNELS:
        k.library()
    launches, seconds, plain = {}, {}, {}
    legs = (
        ("learner_dp1", lambda: _torn_down(cs._learner_dp1_leg, torch, dev)),
        ("plain_run", lambda: plain.update(_plain_run()) or {}),
        ("mesh_cli", lambda: cs._mesh_cli_legs(torch, dev, plain)),
        ("fleet_dp1", lambda: cs._fleet_dp1_leg(torch, dev)),
        ("sampler_dp1", lambda: cs._sampler_dp1_leg(torch, dev)),
        ("mesh_lifecycle1", lambda: cs._mesh_lifecycle1_leg(torch, dev)),
    )
    for label, leg in legs:
        t = time.perf_counter()
        launches.update(leg())
        seconds[label] = time.perf_counter() - t
    print(json.dumps({"launches": launches, "seconds": seconds, "card": name,
                      "power_limit": limit}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
