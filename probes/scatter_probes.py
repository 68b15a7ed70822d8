#!/usr/bin/env python3
"""Time the priority scatter's design probes beside the shipped kernel.

    python3 probes/scatter_probes.py

Run from the root of a checkout on a machine with one CUDA card.  Builds
``probes/scatter_probes.cu`` and the shipped kernel with ``nvcc``, checks the
complete probes and the shipped kernel bitwise against
``priority_scatter_plain`` on every ``scatter_case`` pattern, then prints
one JSON line per batch size with the device time per launch
(``torch.profiler``) at capacity 100k of each probe, of the shipped kernel
through its wrapper and of ``index_put_``.  Each B is drawn from three
seeds, and each seed is measured twice, the second pass in reverse order.
The first line is the card's name and power limit.  The probes are on no
path of the port; ``chip_smoke.py`` holds the shipped kernel to its plain
version.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from r2d2dpg_torch.kernels import Kernel  # noqa: E402
from r2d2dpg_torch.ops.scatter import (  # noqa: E402
    priority_scatter,
    priority_scatter_plain,
)
from r2d2dpg_torch.testing import SCATTER_PATTERNS, scatter_case  # noqa: E402

PROBES = ("empty", "store", "match", "shuffle", "scan", "table_match",
          "registers_match")
COMPLETE = ("scan", "table_match", "registers_match")  # full duplicate rule
BATCHES = (33, 64, 128, 256, 1024)
CAPACITY = 100_000

SCATTER_PROBES = Kernel(
    "scatter_probes",
    {
        "probe_launch": (
            ctypes.c_int,
            (ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p),
        )
    },
    source=HERE / "scatter_probes.cu",
)


def _device_us(name, fn, n=400, attempts=3):
    """Device time per call (CUPTI), microseconds.

    The profiler now and then records no device event in a session; such a
    session is taken again, up to ``attempts`` times.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
        if total > 0:
            return total / n
    raise RuntimeError(f"the profiler saw no device time for {name}")


def main() -> int:
    if not torch.cuda.is_available():
        print("scatter_probes: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card}), flush=True)
    launch_probe = SCATTER_PROBES.function("probe_launch")

    def probe(v, prio, idx, vals):
        err = launch_probe(v, prio.data_ptr(), prio.numel(), idx.data_ptr(),
                           vals.data_ptr(), idx.numel(),
                           torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"probe {PROBES[v]} launch failed: cudaError {err}")

    for b in BATCHES:
        for seed, pattern in enumerate(SCATTER_PATTERNS):
            prio, idx, vals = (torch.from_numpy(a).to(dev)
                               for a in scatter_case(pattern, CAPACITY, b, seed))
            want = priority_scatter_plain(prio.clone(), idx, vals)
            runs = {"shipped": lambda p: priority_scatter(p, idx, vals)}
            for name in COMPLETE:
                runs[name] = lambda p, v=PROBES.index(name): probe(v, p, idx, vals)
            for name, run in runs.items():
                got = prio.clone()
                run(got)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} != plain: {pattern}, B {b}")

        row = {}
        for seed in range(3):
            g = torch.Generator(device=dev).manual_seed(1000 * seed + b)
            prio = torch.rand(CAPACITY, generator=g, device=dev) + 0.1
            idx = torch.randint(0, CAPACITY, (b,), generator=g, device=dev)
            vals = torch.rand(b, generator=g, device=dev)
            fns = {name: (lambda v=v: probe(v, prio, idx, vals))
                   for v, name in enumerate(PROBES)}
            fns["shipped"] = lambda: priority_scatter(prio, idx, vals)
            fns["index_put_"] = lambda: prio.index_put_((idx,), vals)
            for order in (list(fns), list(reversed(fns))):
                for name in order:
                    row.setdefault(name, []).append(_device_us(name, fns[name]))
        print(json.dumps({"b": b, "capacity": CAPACITY, "device_us": row}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
