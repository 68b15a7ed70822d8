"""What the per-layer metric readers (``metrics/<name>.py``) share.

A reader gets the traced run's context: ``trace`` (``trace.profile``'s
device-only pass over ``units`` steps or phases, or a second of serving),
``spans`` (host seconds of each benchmark span over the window),
``units`` and ``window_s`` (the window's steps or phases and its length),
``unit_flops`` (``flops.py``'s count of one unit), ``dtype``, ``device``
and the cell's readings.  It returns None where it finds nothing to read,
and the harness then leaves the metric out.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

from perfbench.trace import kernel_times

SCATTER_KERNEL = "scatter_last_wins"  # the program's kernel, csrc/priority_scatter.cu
PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def card(ctx: Dict) -> Optional[Dict]:
    """The peaks of the card the run used, or None for an unknown card."""
    dev = ctx.get("device")
    if dev is None or dev.type != "cuda":
        return None
    import torch

    name = torch.cuda.get_device_name(dev)
    return next((v for k, v in PEAKS["cards"].items() if k in name), None)


def span_ms(ctx: Dict, name: str) -> Optional[float]:
    s = ctx.get("spans", {}).get(name)
    return 1e3 * sum(s) / len(s) if s else None


def per_unit(ctx: Dict, key: str) -> Optional[float]:
    t = ctx.get("trace")
    if not t or not t["units"]:
        return None
    return t[key] / t["units"]


def idle(ctx: Dict) -> Optional[float]:
    t = ctx.get("trace")
    if not t or t["wall_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["wall_s"]


def mfu(ctx: Dict) -> Optional[float]:
    """Analytic FLOPs of the window's units over its seconds, as a share in
    % of the card's peak in the configuration's compute dtype."""
    peaks = card(ctx)
    if peaks is None or not ctx.get("units"):
        return None
    rate = ctx["unit_flops"] * ctx["units"] / ctx["window_s"]
    return 100.0 * rate / peaks["flops_per_s"][ctx["dtype"]]


def scatter_roofline(ctx: Dict) -> Optional[float]:
    """The priority scatter's least time (its bytes, each input read once and
    each written slot once, over the HBM rate) over its mean time on the
    trace, in %."""
    peaks, t = card(ctx), ctx.get("trace")
    if peaks is None or not t or not ctx.get("scatter_bytes"):
        return None
    n, seconds = kernel_times(t, SCATTER_KERNEL)
    if n == 0 or seconds <= 0:
        return None
    nbytes = sum(ctx["scatter_bytes"]) / len(ctx["scatter_bytes"])
    return 100.0 * (nbytes / peaks["hbm_bytes_per_s"]) / (seconds / n)


def busy_ms(ctx: Dict) -> Optional[float]:
    """Device-busy ms a unit."""
    v = per_unit(ctx, "busy_s")
    return None if v is None else 1e3 * v


def kernel_ms(ctx: Dict, match: str) -> Optional[float]:
    """Device ms a unit in the kernels whose name holds ``match``; None
    where the trace has none."""
    t = ctx.get("trace")
    if not t or not t["units"]:
        return None
    n, seconds = kernel_times(t, match)
    return 1e3 * seconds / t["units"] if n else None
