#!/usr/bin/env python3
"""Benchmark runs with the learner-graph and LSTM-unroll counters read after each.

    python3 probes/learner_graph.py --workload walker_r2d2.learn --seed 7 --seconds 30 \
        [--trace 0] [--runs 1]

From the root of a checkout, on a machine with one CUDA card.  Runs the
cell as ``perfbench/run.py`` does, ``--runs`` times in this process with
seeds ``seed``, ``seed + 1``, ...  (its result line and stderr lines
first), then prints one JSON line a run: the change of
``r2d2dpg_learner_graph_total`` over the run by event and reason, that of
``r2d2dpg_lstm_unroll_total`` by form and reason (host calls: a graph's
warm-up and capture count, its replays do not; eager steps count each), the
learner steps of the window (its units, times the trainer's
``learner_steps`` in a train cell) and all the run's learner steps
(set-up's warm-up units, the window's and, traced, the profiled ones).
Each run builds its own agent and captures its own graph; CUDA's and
the kernels' start-up are warm after the first, so only the first run's
``setup_s`` stands for a fresh process.  The serving cell runs no learner.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

STARTED = time.perf_counter()
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness  # noqa: E402
from r2d2dpg_torch import obs  # noqa: E402
from r2d2dpg_torch.agents.ddpg import UNROLL_METRIC  # noqa: E402
from r2d2dpg_torch.agents.graph import GRAPH_METRIC  # noqa: E402


def counts(metric=GRAPH_METRIC):
    inst = obs.get_registry().get(metric)
    return {} if inst is None else {
        "/".join(k).rstrip("/"): c.value for k, c in inst._cells_snapshot()}


def delta(before, after):
    return {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--runs", type=int, default=1)
    args = p.parse_args()
    cell = harness.find_cell(args.workload)
    traffic = cell.traffic
    per_unit = {"learn": 1, "train": cell.config["trainer"]["learner_steps"]}.get(
        traffic["kind"], 0)
    windows = []
    run_driver = harness.run_driver
    harness.run_driver = lambda run: windows.append(run_driver(run)) or windows[-1]
    started = STARTED
    for i in range(args.runs):
        before, unrolls = counts(), counts(UNROLL_METRIC)
        rc = harness.main(["--workload", args.workload, "--seed", str(args.seed + i),
                           "--seconds", str(args.seconds), "--trace", str(args.trace)],
                          started=started)
        if rc:
            return rc
        units = windows[-1].attempted
        profiled = (traffic.get("trace_units", 0) + traffic.get("breakdown_units", 0)
                    if args.trace else 0)
        print(json.dumps({
            "workload": args.workload, "seed": args.seed + i,
            "graph_counts": delta(before, counts()),
            "lstm_unroll_counts": delta(unrolls, counts(UNROLL_METRIC)),
            "window_learner_steps": units * per_unit,
            "run_learner_steps": (traffic.get("warmup_units", 0) + units + profiled) * per_unit,
        }), flush=True)
        started = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
