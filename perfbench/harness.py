"""The benchmark's frame: find a cell by name, run its traffic's driver,
read its metrics and its correctness numbers, print the result.

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``, whose ``kind`` names the driver in
``drivers/``), its limits (``limits/<cell>.json``) and one reader per
per-layer metric (``metrics/<metric>.py``).  A driver returns a
``Window``; this module turns it into the result line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "r2d2dpg_tpu")


def pin_caches() -> None:
    """Kernel caches at fixed paths inside the checkout (the program's own
    nvcc builds already land in ``build/torch_kernels``)."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    workload: Dict
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]


def find_cell(name: str, manifest: Optional[Dict] = None) -> Cell:
    manifest = manifest or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    conf = next(c for c in manifest["configs"] if c["name"] == w["config"])

    def here(m):
        return "workloads" not in m or name in m["workloads"]

    return Cell(
        workload=w,
        config=load_json(ROOT / conf["file"]),
        traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{name}.json"),
        end_to_end=[m for m in manifest["end_to_end"] if here(m)],
        per_layer=[m for m in manifest["per_layer"] if here(m)],
    )


class Spans:
    """The benchmark's spans around its calls into the program's layers:
    host seconds per call, and with ``trace`` a ``record_function`` range
    ``perfbench/<name>`` the profiler's timeline shows.  Off, a span costs
    nothing."""

    def __init__(self, on: bool):
        self.on = on
        self.seconds: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        import torch

        with torch.profiler.record_function(f"perfbench/{name}"):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.seconds.setdefault(name, []).append(time.perf_counter() - t0)


@dataclasses.dataclass
class Run:
    """What a driver gets: the cell, the run's arguments and its clock."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    started: float  # perf_counter at process start
    spans: Spans = None
    marks: List = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if self.spans is None:
            self.spans = Spans(self.trace)

    def mark(self, name: str) -> None:
        """Note how far set-up has come (seconds since process start)."""
        self.marks.append((name, time.perf_counter() - self.started))


@dataclasses.dataclass
class Window:
    """What a driver hands back."""

    attempted: int
    failed: int
    setup_s: float
    end_to_end: Dict[str, float]
    checks: Dict[str, float]
    memory_peak_bytes: int
    readings: Dict[str, Any] = dataclasses.field(default_factory=dict)
    trace: Optional[Dict] = None
    breakdown: Optional[Dict] = None


def sync(device) -> None:
    """Wait for the device (a no-op on the CPU, where the tests run)."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    import torch

    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def run_driver(run: Run) -> Window:
    kind = run.cell.traffic["kind"]
    return importlib.import_module(f"perfbench.drivers.{kind}").run(run)


def read_metric(name: str, ctx: Dict) -> Optional[float]:
    """The reader ``metrics/<name>.py``'s value, or None when it found nothing."""
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_record(run: Run, window: Window) -> Dict:
    import torch

    dev = {
        "platform": "gpu" if run.device.type == "cuda" else run.device.type,
        "kind": (torch.cuda.get_device_name(run.device) if run.device.type == "cuda"
                 else "cpu"),
        "count": run.cell.workload["chips"],
        "memory_peak_bytes": int(window.memory_peak_bytes),
    }
    if run.trace and window.trace is not None:
        dev["busy_s"] = window.trace["busy_s"]
        dev["window_s"] = window.trace["wall_s"]
    return dev


def result(run: Run, window: Window) -> Dict:
    """The result line's object, ``checks`` last."""
    cell = run.cell
    metrics: Dict[str, Dict] = {}
    if not run.trace:
        values = dict(window.end_to_end, setup_s=window.setup_s)
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        ctx = dict(window.readings, trace=window.trace, spans=run.spans.seconds,
                   config=cell.config, device=run.device)
        for m in cell.per_layer:
            v = read_metric(m["name"], ctx)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    from perfbench.compare import verdict

    checks = verdict(window.checks, cell.limits)
    out = {
        "correct": all(c["ok"] for c in checks) and bool(checks),
        "attempted": int(window.attempted),
        "failed": int(window.failed),
        "metrics": metrics,
        "device": device_record(run, window),
    }
    if run.trace and window.breakdown is not None:
        out["breakdown"] = window.breakdown
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return out


def main(argv: Optional[List[str]] = None, started: Optional[float] = None) -> int:
    import argparse

    started = time.perf_counter() if started is None else started
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    pin_caches()
    cell = find_cell(args.workload)
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = Run(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
              device=torch.device("cuda", 0), started=started)
    card_line(sys.stderr)
    return finish(run, run_driver(run))


def finish(run: Run, window: Window) -> int:
    """Print the run's result, or nothing where a forbidden module was
    loaded in this process; the exit code."""
    out = result(run, window)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded in this process: {bad}", file=sys.stderr)
        return 3
    print("setup: " + ", ".join(f"{n} {t:.2f} s" for n, t in run.marks), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


def fault_exit(run: Run, reason: str) -> None:
    """End a run on several chips that cannot finish (a rank failed, missed
    a time limit or loaded a forbidden module) with its failed result:
    ``rank_faults`` 1 and nothing measured; exit code 0, or 3 without a
    result where this process loaded a forbidden module."""
    print(f"perfbench: {reason}", file=sys.stderr, flush=True)
    window = Window(attempted=0, failed=1, setup_s=time.perf_counter() - run.started,
                    end_to_end={}, checks={"rank_faults": 1.0},
                    memory_peak_bytes=peak_bytes(run.device))
    code = finish(dataclasses.replace(run, trace=False), window)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def card_line(stream) -> None:
    """The card's name and power limit, where nvidia-smi answers."""
    import subprocess

    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        line = "nvidia-smi unavailable"
    print(f"card: {line}", file=stream, flush=True)
