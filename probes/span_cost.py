#!/usr/bin/env python3
"""The cost of one of the program's spans, and the clock its start uses.

    python3 probes/span_cost.py

From the root of a checkout, on a machine with one CUDA card.  Prints the
card's name and power limit, then JSON lines: microseconds per
``annotate`` span with timing off and no profiler (``off``, with its NVTX
push and pop; ``off_before_cuda`` before CUDA starts, without them), with
timing on (``on``) and with a profiler session and timing off
(``profiler``), each over an empty loop's time; and, in one
``torch.profiler`` trace, each span's profiler-range start less its
start in the flight ring (``clock_gap_us``, in order), with the
device-side events of the probe's ranges (``device_side``: name, device,
``is_user_annotation``).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from r2d2dpg_torch import obs  # noqa: E402
from r2d2dpg_torch.utils.profiling import annotate  # noqa: E402

N = 200_000


def per_span_us(body) -> float:
    t0 = time.perf_counter()
    for _ in range(N):
        body()
    return (time.perf_counter() - t0) / N * 1e6


def empty():
    pass


def span():
    with annotate("probe/span"):
        pass


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    out = {"torch": torch.__version__}
    obs.enable_spans(False)
    base = min(per_span_us(empty) for _ in range(3))
    out["off_before_cuda"] = min(per_span_us(span) for _ in range(3)) - base
    x = torch.ones(1024, device="cuda")
    torch.cuda.synchronize()
    base = min(per_span_us(empty) for _ in range(3))
    out["off"] = min(per_span_us(span) for _ in range(3)) - base
    obs.enable_spans(True)
    out["on"] = min(per_span_us(span) for _ in range(3)) - base
    obs.enable_spans(False)
    print(json.dumps(out), flush=True)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        out["profiler"] = per_span_us(span) - base
    ring = obs.get_flight_recorder()
    ring.clear_spans()
    obs.enable_spans(True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(20):
            with annotate("probe/clock", i + 1):
                (x * 2).sum()
        torch.cuda.synchronize()
    obs.enable_spans(False)
    raw = prof.profiler.kineto_results.events()
    host = sorted(e.start_ns() for e in raw
                  if e.name() == "probe/clock" and e.device_type().name == "CPU")
    ringed = sorted(round(s["t_wall"] * 1e9) for s in ring.spans() if s["hop"] == "probe/clock")
    gaps = [(a - b) / 1e3 for a, b in zip(host, ringed)]  # trace start - ring start
    out["clock_gap_us"] = {"each": [round(g, 2) for g in gaps],
                           "median": sorted(gaps)[len(gaps) // 2]}
    out["device_side"] = sorted({(e.name(), e.device_type().name, e.is_user_annotation())
                                 for e in raw if e.device_type().name != "CPU"
                                 and e.name().startswith("probe/")})
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
