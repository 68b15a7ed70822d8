"""A short profiled sub-window and what the benchmark reads off its trace.

``profile(fn, units)`` runs ``fn`` ``units`` times under ``torch.profiler``
and returns the device timeline reduced to what the metric readers need:
busy seconds (the union of every device activity's interval), the traced
wall seconds, kernel counts and times by name.  With ``host=True`` it also
records the host side (every op and the ``perfbench/<layer>`` ranges) and
names each idle gap of the device by what the host was doing: the
innermost benchmark span over the gap's middle and the outermost program
op there.  Recording host ops slows the host, so the busy and idle numbers
come from a device-only pass and the names from a second, shorter one.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

import torch

COPY_PREFIXES = ("memcpy", "memset")


def _events(prof) -> List[Tuple[str, bool, float, float]]:
    """``(name, on_device, start_s, end_s)`` of every event of the trace, from
    the Kineto results (a torch without them fails here, loudly)."""
    from torch.autograd import DeviceType

    raw = prof.profiler.kineto_results.events()
    base = min((e.start_ns() for e in raw), default=0)  # seconds stay exact in float
    out = []
    for e in raw:
        start = e.start_ns() - base
        out.append((e.name(), e.device_type() == DeviceType.CUDA, start * 1e-9,
                    (start + e.duration_ns()) * 1e-9))
    return out


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def profile(fn: Callable[[], None], units: int, host: bool = False) -> Dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    cuda = torch.cuda.is_available()  # the CPU tests trace the host alone
    acts = ([ProfilerActivity.CUDA] if cuda else []) + (
        [ProfilerActivity.CPU] if host or not cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            fn()
        sync()
        wall = time.perf_counter() - t0
    events = _events(prof)
    # The benchmark's own ranges also show on the device's timeline; they
    # are no device work.
    dev = [(n, s, e) for n, d, s, e in events if d and not n.startswith("perfbench/")]
    busy = _union([(s, e) for _, s, e in dev])
    by_name: Dict[str, List[float]] = {}
    for n, s, e in dev:
        by_name.setdefault(n, []).append(e - s)
    kernels = sum(len(v) for n, v in by_name.items()
                  if not n.lower().startswith(COPY_PREFIXES))
    out = {
        "units": units,
        "wall_s": wall,
        "busy_s": sum(e - s for s, e in busy),
        "kernels": kernels,
        "device_events": len(dev),
        "by_name": {n: (len(v), sum(v)) for n, v in by_name.items()},
    }
    if host:
        out["gaps"] = _named_gaps(busy, [(n, s, e) for n, d, s, e in events if not d])
    return out


def _named_gaps(busy, host_events, top: int = 10) -> List[Tuple[str, float]]:
    """The ``top`` longest idle gaps between device activity, each named by
    the host's state at its middle: ``<benchmark span> > <outermost op>``."""
    gaps = sorted(((s1 - e0, e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:])),
                  reverse=True)[:top]
    out = []
    for length, e0, s1 in gaps:
        mid = (e0 + s1) / 2
        spans = [(e - s, n) for n, s, e in host_events
                 if n.startswith("perfbench/") and s <= mid <= e]
        ops = [(s, -e, n) for n, s, e in host_events
               if not n.startswith("perfbench/") and s <= mid <= e]
        span = min(spans)[1] if spans else "outside perfbench spans"
        op = min(ops)[2] if ops else "python"
        out.append((f"{span} > {op}", length))
    return out


def breakdown(metrics_pass: Dict, names_pass: Dict, top: int = 10) -> Dict:
    ops = sorted(((n, t) for n, (_, t) in metrics_pass["by_name"].items()),
                 key=lambda x: -x[1])[:top]
    gaps = sorted(names_pass.get("gaps", []), key=lambda x: -x[1])[:top]
    return {"device_ops": [[n[:120], t] for n, t in ops],
            "idle_gaps": [[n[:120], t] for n, t in gaps]}


def kernel_times(trace: Dict, match: str) -> List[float]:
    """Count and total seconds of the device events whose name holds ``match``."""
    n, t = 0, 0.0
    for name, (c, s) in trace["by_name"].items():
        if match in name:
            n, t = n + c, t + s
    return [n, t]
