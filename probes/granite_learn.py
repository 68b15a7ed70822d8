#!/usr/bin/env python3
"""walker_granite.learn's readings for its limits, with the program's planted
faults, and its trace's kernels by name.

    python3 probes/granite_learn.py --seeds 1,2,3 [--fault none|mamba|attention] \
        [--seconds 0] [--trace 0] [--kernels runs/granite_kernels.json]

From the root of a checkout, on a machine with one CUDA card.  For each
seed it runs the cell as ``perfbench/run.py`` does (set-up, the checked
steps, ``--seconds`` of updates, the reference) and prints one JSON line:
the correctness numbers (``checks``, ``wide``), ``setup_s``, the window's
steps a second, the memory peak and the learner-graph counter's change
by event and reason.  ``--fault`` plants one of the program's faults that
the check is there to see: the Mamba-2 mixers' sequence form (the SSM's
state and the convolution's taps) or the attention's mask let through
every reset inside a sequence.  ``--kernels`` (with ``--trace 1``) writes
the first traced run's device kernels, each with its count, seconds and
whether ``perfbench/gemm.py`` takes it for a matrix product.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from perfbench import gemm, harness  # noqa: E402

CELL = "walker_granite.learn"


def plant(fault: str) -> None:
    """Every reset inside a sequence left uncut in one kind of mixer."""
    if fault == "none":
        return
    from r2d2dpg_torch.models import granite

    cls = {"mamba": granite.Mamba2Mixer, "attention": granite.GQAttention}[fault]
    real = cls._sequence
    cls._sequence = lambda self, x, carry, seg: real(self, x, carry, torch.zeros_like(seg))


def graph_counts():
    from r2d2dpg_torch.agents.graph import GRAPH_METRIC
    from r2d2dpg_torch.obs.registry import get_registry

    snap = get_registry().snapshot().get(GRAPH_METRIC, {"samples": []})
    return {f"{s['labels']['event']}:{s['labels']['reason']}": s["value"]
            for s in snap["samples"]}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", required=True)
    p.add_argument("--fault", default="none", choices=("none", "mamba", "attention"))
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--kernels", default=None)
    args = p.parse_args()
    harness.pin_caches()
    plant(args.fault)
    cell = harness.find_cell(CELL)
    device = torch.device("cuda", 0)
    torch.cuda.init()
    harness.card_line(sys.stderr)
    for seed in (int(s) for s in args.seeds.split(",")):
        before = graph_counts()
        torch.cuda.reset_peak_memory_stats(device)
        run = harness.Run(cell=cell, seed=seed, seconds=args.seconds, trace=bool(args.trace),
                          device=device, started=time.perf_counter())
        window = harness.run_driver(run)
        after = graph_counts()
        rec = {"workload": CELL, "seed": seed, "fault": args.fault, "checks": window.checks,
               "wide": window.readings.get("wide"), "setup_s": window.setup_s,
               "steps_per_s": window.end_to_end.get("learner_steps_per_s"),
               "units": window.attempted, "failed": window.failed,
               "memory_peak_bytes": window.memory_peak_bytes,
               "graph": {k: v - before.get(k, 0) for k, v in after.items()
                         if v != before.get(k, 0)},
               "marks": run.marks}
        if run.trace:
            out = harness.result(run, window)
            rec["metrics"] = out["metrics"]
            rec["device"] = out["device"]
            rec["breakdown"] = out.get("breakdown")
            if args.kernels:
                rows = sorted(((n, c, s, gemm.is_gemm(n))
                               for n, (c, s) in window.trace["by_name"].items()),
                              key=lambda r: -r[2])
                Path(args.kernels).parent.mkdir(parents=True, exist_ok=True)
                Path(args.kernels).write_text(json.dumps(
                    {"units": window.trace["units"], "kernels": rows}, indent=0))
                args.kernels = None
        print(json.dumps(rec), flush=True)
        del window, run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
