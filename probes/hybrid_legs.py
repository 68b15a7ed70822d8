#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s host-pool trainer leg alone, then its fleet legs
with the drain-stall trace.

    python3 probes/hybrid_legs.py [--pendulum-pipelined] [--fleet N]
        [--autoscale-threads default,1,1,default]

Run from the root of a checkout on a machine with a CUDA card.  Builds the
port's kernels, then runs ``hybrid1`` exactly as ``chip_smoke.py`` runs it
(``HostSPMDTrainer`` at walker_r2d2's width on the host stand-in env,
sequential over NCCL, overlapped, pipelined, and pipelined over a mesh of
one twice from one state; any failed check raises).  With
``--pendulum-pipelined`` it then runs ``chip_smoke.py``'s pipelined
pendulum_r2d2 leg (``train.main --pipeline 1 --phases 40``).
With ``--fleet N`` it then runs the ``fleet_f32`` leg and N times the
``fleet_autoscale`` leg, each printing its ``<label>_drain_stalls`` record
(where every drain-learn iteration of 0.5 s or more spent its time, and
the sheds' times); a failed fleet check is printed with its message and
the next leg runs (this probe reads the trace; ``chip_smoke.py`` holds the
checks).  ``--autoscale-threads`` runs the ``fleet_autoscale`` leg once per
listed count with the actors' ``OMP_NUM_THREADS`` set to it (the
supervisor's default is 1; ``default`` is torch's own count in this
process, which children got before that default), in the order listed, so two settings take turns on one host.
Without ``--skip-hybrid`` the ``hybrid1`` leg runs first.  The first line
is the card's name and power limit; the last gives each leg's scatter
launches and seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from r2d2dpg_torch import kernels, resolve_device  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--fleet", type=int, default=0,
                   help="fleet_autoscale runs after the fleet_f32 leg (0: no fleet leg)")
    p.add_argument("--autoscale-threads", default="",
                   help="comma-separated actor intra-op thread counts, one "
                   "fleet_autoscale run each")
    p.add_argument("--skip-hybrid", action="store_true")
    p.add_argument("--pendulum-pipelined", action="store_true",
                   help="then chip_smoke.py's pipelined pendulum_r2d2 leg")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("hybrid_legs: no CUDA card available", file=sys.stderr)
        return 1
    dev = resolve_device("cuda")
    raw, name, limit = cs._card_line()
    print(raw, flush=True)
    kernels.build_all(kernels.ALL_KERNELS)
    for k in kernels.ALL_KERNELS:
        k.library()
    launches, seconds, failed = {}, {}, {}
    legs = [] if args.skip_hybrid else [("hybrid1", lambda: cs._hybrid1_leg(torch, dev),
                                          False)]
    if args.pendulum_pipelined:
        legs.append(("pipelined", lambda: cs._pipelined_phase(torch, dev), False))

    # torch's own default intra-op thread count in this process, before any
    # child is given another.
    default_threads = str(torch.get_num_threads())
    print(json.dumps({"host_cpus": os.cpu_count(), "torch_threads": default_threads,
                      "env_omp_threads": os.environ.get("OMP_NUM_THREADS")}), flush=True)

    def threads_leg(i, n):
        n = default_threads if n == "default" else n

        def leg():
            os.environ["OMP_NUM_THREADS"] = n
            try:
                return cs._fleet_autoscale_leg(torch, dev, f"fleet_autoscale_t{n}_{i}")
            finally:
                del os.environ["OMP_NUM_THREADS"]
        return leg

    for i, n in enumerate(x for x in args.autoscale_threads.split(",") if x):
        legs.append((f"fleet_autoscale_t{n}_{i}", threads_leg(i, n), True))
    if args.fleet:
        legs.append(("fleet_f32", lambda: cs._fleet_leg(torch, dev, "fleet_f32", ()), True))
    for i in range(args.fleet):
        legs.append((f"fleet_autoscale{i}",
                     lambda i=i: cs._fleet_autoscale_leg(torch, dev, f"fleet_autoscale{i}"),
                     True))
    for label, leg, traced in legs:
        t = time.perf_counter()
        try:
            launches.update(leg())
        except AssertionError as e:
            if not traced:
                raise
            failed[label] = str(e)[:2000]
            print(json.dumps({f"{label}_failed": failed[label]}), flush=True)
        seconds[label] = time.perf_counter() - t
    print(json.dumps({"launches": launches, "seconds": seconds, "failed": failed,
                      "card": name, "power_limit": limit}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
