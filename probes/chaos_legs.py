#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s chaos legs alone, with all their checks.

    python3 probes/chaos_legs.py

Run from the root of a checkout on a machine with one CUDA card (about
six minutes on an H100 host).  Builds the port's kernels, then runs
``fleet_chaos`` (the central drain under kill_actor, corrupt_frame,
stall_actor and kill_ingest_conn, with ``--obs-fleet 1``),
``fleet_autoscale`` (a kill and a stall replaced by the autoscaler),
``direct_chaos`` (the direct data plane under its five drills) and the
shard-procs leg with ``kill_shard@p20`` and ``--obs-fleet 1``, each
exactly as ``chip_smoke.py`` runs it: any failed check raises.  The first line is the card's name and power limit; each
leg prints its JSON record; the last line gives each leg's scatter
launches and seconds.  Here the fleet leg runs first in the process, so
its first drain also pays the card's warm-up.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from r2d2dpg_torch import kernels, resolve_device  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chaos_legs: no CUDA card available", file=sys.stderr)
        return 1
    dev = resolve_device("cuda")
    raw, name, limit = cs._card_line()
    print(raw, flush=True)
    kernels.build_all(kernels.ALL_KERNELS)
    for k in kernels.ALL_KERNELS:
        k.library()
    legs = (
        ("fleet_chaos", lambda: cs._fleet_chaos_leg(torch, dev)),
        ("fleet_autoscale", lambda: cs._fleet_autoscale_leg(torch, dev)),
        ("direct_chaos", lambda: cs._sampler_leg(
            torch, dev, "direct_chaos", cs.DIRECT_CHAOS_FLAGS, cs.DIRECT_CHAOS_PHASES)),
        ("sampler_shard_procs", lambda: cs._sampler_leg(
            torch, dev, "sampler_shard_procs", cs.SAMPLER_KILL_FLAGS,
            cs.SAMPLER_PROCS_TRAIN_PHASES)),
    )
    launches, seconds = {}, {}
    for label, leg in legs:
        t = time.perf_counter()
        launches.update(leg())
        seconds[label] = time.perf_counter() - t
    print(json.dumps({"launches": launches, "seconds": seconds, "card": name,
                      "power_limit": limit}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
