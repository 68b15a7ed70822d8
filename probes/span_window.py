#!/usr/bin/env python3
"""One traced benchmark run, with the program's spans read over its window.

    python3 probes/span_window.py --workload walker_r2d2.learn --seed 7 --seconds 30

From the root of a checkout, on a machine with one CUDA card.  Turns the
program's span timing on (``obs.enable_spans``), runs the cell as
``perfbench/run.py --trace 1`` does, and prints the result line and then
one JSON line: the window's end-to-end metrics (the result line of a
traced run carries the per-layer ones only), the host ms a unit in each of
the program's spans over the window's units alone (registry snapshots at
the window's start and end; the checked and warm-up units and the
profiled passes do not count), in a learn cell the share of the
benchmark's ``sample`` + ``learner_step`` host time over the same steps
that the program's ``learner/*`` and ``replay/*`` spans cover, and in the
serving cell the p95 of the last queue waits at the window's end and the
worker's busy share (``serve/admit`` + ``serve/policy_step`` +
``serve/answer`` over the window's seconds).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

STARTED = time.perf_counter()
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from perfbench import harness  # noqa: E402
from perfbench.traffic import client as traffic_client  # noqa: E402
from r2d2dpg_torch import obs  # noqa: E402
from r2d2dpg_torch.serving.batcher import QUEUE_WAIT_METRIC  # noqa: E402
from r2d2dpg_torch.utils.profiling import SPAN_METRIC  # noqa: E402

UNIT_SPAN = {"learn": "learner_step", "train": "train_phase"}
WORKER_BUSY = ("serve/admit", "serve/policy_step", "serve/answer")


def snapshot():
    """Count and total seconds of each program span, and the queue waits'
    count and window p95 (seconds), now."""
    reg = obs.get_registry()
    spans = {s["labels"]["span"]: (s["count"], s["total"])
             for s in reg.snapshot().get(SPAN_METRIC, {}).get("samples", ())}
    wait = reg.get(QUEUE_WAIT_METRIC)
    return {"spans": spans,
            "queue_wait": None if wait is None else (wait.count, wait.percentiles((95.0,))[0])}


class UnitSpans(harness.Spans):
    """The benchmark's spans, with a snapshot after each unit's span."""

    def __init__(self, unit: str):
        super().__init__(True)
        self.unit, self.snaps = unit, []

    @contextlib.contextmanager
    def __call__(self, name):
        with super().__call__(name):
            yield
        if name == self.unit:
            self.snaps.append(snapshot())


def measure(cell: harness.Cell, seed: int, seconds: float, device, started: float):
    """The traced run's result line and the window's program-span numbers."""
    kind = cell.traffic["kind"]
    obs.enable_spans(True)
    window_snaps = []
    plain = traffic_client.Client.run
    if kind == "serve":
        def run_recorded(self, seconds, record=None):
            if record is None:
                return plain(self, seconds)
            window_snaps.append(snapshot())
            out = plain(self, seconds, record=record)
            window_snaps.append(snapshot())
            return out

        traffic_client.Client.run = run_recorded
        spans = harness.Spans(True)
    else:
        spans = UnitSpans(UNIT_SPAN[kind])
    run = harness.Run(cell=cell, seed=seed, seconds=seconds, trace=True, device=device,
                      started=started, spans=spans)
    try:
        window = harness.run_driver(run)
    finally:
        traffic_client.Client.run = plain
        obs.enable_spans(False)
    units = window.readings.get("units") or 1
    if kind == "serve":
        start, end = window_snaps
    else:
        w0 = cell.traffic["warmup_units"]
        start, end = spans.snaps[w0 - 1], spans.snaps[w0 + units - 1]
    s0, s1 = start["spans"], end["spans"]
    took = {n: s1[n][1] - s0.get(n, (0, 0.0))[1] for n in sorted(s1)
            if s1[n][0] > s0.get(n, (0, 0.0))[0]}
    out = {"workload": cell.workload["name"], "seed": seed, "end_to_end": window.end_to_end,
           "units": window.readings.get("units"), "window_s": window.readings["window_s"],
           "span_ms_per_unit": {n: 1e3 * v / units for n, v in took.items()}}
    if kind == "learn":
        bench = sum(sum(spans.seconds[k][w0:w0 + units]) for k in ("sample", "learner_step"))
        prog = sum(v for n, v in took.items() if n.startswith(("learner/", "replay/")))
        out.update(bench_ms_per_step=1e3 * bench / units, coverage=prog / bench)
    if kind == "serve":
        if end["queue_wait"] is not None:
            out["queue_wait_p95_ms"] = 1e3 * end["queue_wait"][1]
        out["worker_busy"] = (sum(took.get(n, 0.0) for n in WORKER_BUSY)
                              / window.readings["window_s"])
    return harness.result(run, window), out


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    args = p.parse_args()
    harness.pin_caches()
    harness.card_line(sys.stdout)
    line, out = measure(harness.find_cell(args.workload), args.seed, args.seconds,
                        torch.device("cuda", 0), STARTED)
    print(json.dumps(line), flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
