#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card.  Phases
(any failure exits nonzero; nothing is caught):

1. the card's name and power limit, as nvidia-smi reports them;
2. build every CUDA kernel of the port from ``r2d2dpg_torch/csrc/``;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes plus edge cases (bitwise): for the scatter, duplicates
   inside a warp and across warps, every index the same, every index out
   of range, B from 1 to 8,192 (blocks of 1,024 threads past 1,024);
   its time per launch
   beside the plain version's, ``index_put_``'s (also under
   ``torch.use_deterministic_algorithms``) and an empty kernel's launched
   the same way (the launch floor);
4. one ``ReplayArena.update_priorities`` call captured in a CUDA graph and
   replayed on fresh inputs, bitwise against the plain version (a launch
   count sees the capture, not the replays, so no count is read there);
5. the learner step at the walker_r2d2 shapes the headline benchmark
   measures (hidden 256, obs 24, act 6, batch 64, seq 43, capacity 100k,
   4,096 resident sequences): >= 100 steps of sample -> learner_step ->
   update_priorities, metrics finite, one kernel launch per step;
6. the port's learner on the card against the same learner on the CPU at
   pendulum_tiny shapes (the CPU path is the one held to the JAX reference
   by tests/test_torch_*.py);
7. the main path through its entry point: ``r2d2dpg_torch.train.main`` on
   ``pendulum_r2d2`` (warm-up 4 + replay fill 50 + 10 train phases), with
   every launch count set to 0 just before and read just after;
8. one JSON line per kernel summary, then the last line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and nothing of ``r2d2dpg_tpu``.  Without a card,
or outside a checkout of the repo, it exits nonzero and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak memory rate


def _event_ms(fns, n):
    """Median ms per call of each of ``fns`` (name -> fn) by CUDA events.

    Each call is bracketed by its own pair of events, and the functions take
    turns within every round, so all of them see the same host conditions.
    """
    import torch

    for fn in fns.values():  # warm-up
        fn()
    torch.cuda.synchronize()
    pairs = {name: [] for name in fns}
    for _ in range(n):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs[name].append((start, end))
    torch.cuda.synchronize()
    return {name: statistics.median(s.elapsed_time(e) for s, e in p)
            for name, p in pairs.items()}


def _device_profile(fn, n):
    """(device ms per call, top kernels) over ``n`` calls, from torch.profiler.

    Sums the durations of the device-side events (kernels, copies) CUPTI
    recorded; ``None`` when the profiler saw no device time.
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    total_us = sum(by_name.values())
    if total_us <= 0:
        return None, []
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return total_us / n / 1e3, [(k[:60], v / n / 1e3) for k, v in top]


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name, limit = (x.strip() for x in out.split(",", 1))
    return out, name, limit


@contextlib.contextmanager
def _deterministic(torch, on):
    """``torch.use_deterministic_algorithms(on)`` inside, restored after."""
    prev = torch.are_deterministic_algorithms_enabled()
    prev_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(on)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=prev_warn)


def _scatter_phase(torch, dev):
    """Kernel vs plain on the card (bitwise); times at the main path's shapes."""
    from r2d2dpg_torch.kernels import PRIORITY_SCATTER
    from r2d2dpg_torch.ops.scatter import (
        _LAUNCH_RECORD,
        priority_scatter,
        priority_scatter_plain,
    )
    from r2d2dpg_torch.testing import SCATTER_PATTERNS, scatter_case

    def on_card(case):
        return tuple(torch.from_numpy(a).to(dev) for a in case)

    # The learner's shapes with forced duplicates and out-of-range indices,
    # then every pattern at batch sizes that cover one lane, ragged and whole
    # warps, one block of 1,024 threads and several blocks past it.
    grid = [("mixed", c, b) for c in (100_000, 50_000, 300) for b in (64, 256)]
    grid += [(p, 100_000, b) for p in SCATTER_PATTERNS
             for b in (1, 31, 32, 33, 64, 65, 100, 256, 1024, 1025, 4096, 8192)]
    cases = []
    library_matches = {"library": [], "library_deterministic": []}
    for seed, (pattern, capacity, b) in enumerate(grid):
        prio, idx, vals = on_card(scatter_case(pattern, capacity, b, seed))
        want = priority_scatter_plain(prio.clone(), idx, vals)
        got = priority_scatter(prio.clone(), idx, vals)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"kernel != plain: {pattern}, capacity {capacity}, B {b}")
        err = (got - want).abs().max().item()
        cases.append({"pattern": pattern, "capacity": capacity, "b": b,
                      "max_abs_err": err})
        # index_put_ does not promise which duplicate wins: record whether
        # it happened to agree (in-range indices only; it faults on others).
        if pattern in ("mixed", "repeat", "all_same"):
            keep = (idx >= 0) & (idx < capacity)
            idx_in, vals_in = idx[keep], vals[keep]
            for name, det in (("library", False), ("library_deterministic", True)):
                with _deterministic(torch, det):
                    lib = prio.clone().index_put_((idx_in,), vals_in)
                    torch.cuda.synchronize()
                library_matches[name].append(bool(torch.equal(lib, want)))
    print(json.dumps({"priority_scatter_cases": cases}), flush=True)
    matches = {k: {"matched": sum(v), "cases": len(v)} for k, v in library_matches.items()}
    print(json.dumps({"index_put_matches_plain_on_duplicates": matches}), flush=True)

    # Launch floor: an empty kernel through the same route (a packed launch
    # record, one ctypes call), without the wrapper's checks.
    floor_fn = PRIORITY_SCATTER.function("launch_floor")

    def launch_floor():
        stream = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
        if floor_fn(_LAUNCH_RECORD.pack(0, 0, 0, 0, 0, 0, 0, stream)) != 0:
            raise RuntimeError("launch_floor kernel launch failed")

    def device_ms(fn, n):
        # Device time (CUPTI) is the kernel's own time; None if not traced.
        ms, top = _device_profile(fn, n)
        return ms, [name for name, _ in top]

    floor_ms, _ = device_ms(launch_floor, 500)

    # Timing at the learner's shapes: B sampled (in-range, duplicates
    # allowed) slots of the walker (100k) and pendulum_r2d2 (50k) arenas.
    # The CUDA-event time per call also holds the host's launch gap; the
    # kernel, index_put_ and the launch floor take turns for it.
    g = torch.Generator(device=dev).manual_seed(0)
    timings = []
    for capacity, b in ((100_000, 64), (50_000, 64), (100_000, 256)):
        prio = torch.rand(capacity, generator=g, device=dev) + 0.1
        idx = torch.randint(0, capacity, (b,), generator=g, device=dev)
        vals = torch.rand(b, generator=g, device=dev)

        def kernel():
            priority_scatter(prio, idx, vals)

        def plain():
            priority_scatter_plain(prio, idx, vals)

        def library():
            prio.index_put_((idx,), vals)

        rec = {"capacity": capacity, "b": b, "launch_floor_ms": floor_ms}
        for name, fn, n, det in (("kernel", kernel, 500, False),
                                 ("plain", plain, 20, False),
                                 ("library", library, 500, False),
                                 ("library_deterministic", library, 500, True)):
            with _deterministic(torch, det):
                rec[f"{name}_ms"], kernels = device_ms(fn, n)
            if name.startswith("library"):
                rec[f"{name}_device_kernels"] = kernels
        events = _event_ms(
            {"kernel": kernel, "library": library, "launch_floor": launch_floor}, 500)
        events["plain"] = _event_ms({"plain": plain}, 20)["plain"]
        with _deterministic(torch, True):
            events["library_deterministic"] = _event_ms({"x": library}, 500)["x"]
        for name, ms in events.items():
            rec[f"{name}_event_ms"] = ms
        for name in ("kernel", "plain", "library", "library_deterministic"):
            if rec[f"{name}_ms"] is None:  # the profiler saw no device time
                rec[f"{name}_ms"] = rec[f"{name}_event_ms"]
                rec[f"{name}_timing"] = "events"
            else:
                rec[f"{name}_timing"] = "profiler"
        winners = torch.unique(idx).numel()
        # bytes the function must move: each index (8 B) and value (4 B) read
        # once, each winning slot (4 B) written once.
        nbytes = 12 * idx.numel() + 4 * winners
        rec.update(bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                   kernel_over_library=rec["kernel_ms"] / rec["library_ms"],
                   event_kernel_over_library=(
                       rec["kernel_event_ms"] / rec["library_event_ms"]))
        timings.append(rec)
    print(json.dumps({"priority_scatter_timing": timings}), flush=True)
    return max(c["max_abs_err"] for c in cases), timings[0]


def _graph_phase(torch, dev, capacity=100_000, batch=64):
    """One ``ReplayArena.update_priorities`` call captured in a CUDA graph.

    Replayed on fresh sampled indices (one forced duplicate) and priorities
    (some below ``PRIORITY_EPS``) copied into the captured buffers; each
    replay must equal the plain version bitwise.
    """
    from r2d2dpg_torch.ops.priority import PRIORITY_EPS
    from r2d2dpg_torch.ops.scatter import priority_scatter_plain
    from r2d2dpg_torch.replay import ReplayArena, SequenceBatch

    g = torch.Generator(device=dev).manual_seed(2)
    z = torch.zeros(capacity, 1, device=dev)
    example = SequenceBatch(obs=z, action=z, reward=z, discount=z, reset=z, carries={})
    arena = ReplayArena(capacity, prioritized=True)
    state = arena.init_state(example)
    arena.add(state, example, torch.rand(capacity, generator=g, device=dev) + 0.5)
    idx_buf = arena.sample(state, batch, generator=g).indices.clone()
    prio_buf = torch.rand(batch, generator=g, device=dev)
    arena.update_priorities(state, idx_buf, prio_buf)  # load the kernel first
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        arena.update_priorities(state, idx_buf, prio_buf)
    replays = 3
    for _ in range(replays):
        idx_buf.copy_(arena.sample(state, batch, generator=g).indices)
        idx_buf[-1] = idx_buf[0]
        prio_buf.copy_(torch.rand(batch, generator=g, device=dev) * 2 - 0.5)
        before = state.priority.clone()
        graph.replay()
        want = priority_scatter_plain(before, idx_buf, prio_buf.clamp_min(PRIORITY_EPS))
        torch.cuda.synchronize()
        if not torch.equal(state.priority, want):
            raise AssertionError("CUDA graph replay of update_priorities != plain")
    print(json.dumps({"update_priorities_cuda_graph": {
        "capacity": capacity, "b": batch, "replays": replays, "bitwise_equal": True,
    }}), flush=True)


def _walker_learner_phase(torch, dev, steps=120, warmup=10):
    """sample -> learner_step -> update_priorities at the walker shapes."""
    from r2d2dpg_torch.agents import R2D2DPG
    from r2d2dpg_torch.configs import WALKER_R2D2
    from r2d2dpg_torch.kernels import PRIORITY_SCATTER
    from r2d2dpg_torch.models import ActorNet, CriticNet
    from r2d2dpg_torch.replay import ReplayArena, SequenceBatch

    batch, obs_dim, act_dim, hidden = 64, 24, 6, 256
    cfg = WALKER_R2D2.agent
    seq_len, capacity, fill = cfg.seq_len, 100_000, 4096
    actor = ActorNet(obs_dim, act_dim, hidden=hidden)
    critic = CriticNet(obs_dim, act_dim, hidden=hidden)
    agent = R2D2DPG(actor, critic, cfg)
    g = torch.Generator(device=dev).manual_seed(0)
    seqs = SequenceBatch(
        obs=torch.randn(fill, seq_len, obs_dim, generator=g, device=dev),
        action=torch.rand(fill, seq_len, act_dim, generator=g, device=dev) * 2 - 1,
        reward=torch.randn(fill, seq_len, generator=g, device=dev),
        discount=torch.ones(fill, seq_len, device=dev),
        reset=torch.zeros(fill, seq_len, device=dev),
        carries={
            "actor": actor.initial_carry(fill, dev),
            "critic": critic.initial_carry(fill, dev),
        },
    )
    arena = ReplayArena(capacity, prioritized=True)
    state = arena.init_state(seqs)
    arena.add(state, seqs, torch.rand(fill, generator=g, device=dev) + 0.5)
    train = agent.init(torch.Generator().manual_seed(0), dev)
    w = torch.ones(batch, device=dev)
    torch.cuda.synchronize()

    PRIORITY_SCATTER.launches = 0
    finite = []
    for i in range(steps):
        if i == warmup:  # time the steps after the first few (allocator, cuBLAS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        res = arena.sample(state, batch, generator=g)
        train, prios, metrics = agent.learner_step(train, res.batch, w)
        arena.update_priorities(state, res.indices, prios)
        finite.append(torch.isfinite(torch.stack(list(metrics.values()))).all())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = PRIORITY_SCATTER.launches
    if not bool(torch.stack(finite).all()):
        raise AssertionError("non-finite learner metrics at the walker shapes")
    if launches != steps:
        raise AssertionError(f"{launches} scatter launches for {steps} learner steps")
    rec = {
        "walker_learner": {
            "steps": steps, "timed_steps": steps - warmup, "seconds": dt,
            "steps_per_s": (steps - warmup) / dt,
            "scatter_launches": launches,
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "last_metrics": {k: float(v) for k, v in metrics.items()},
        }
    }

    def one_step():
        nonlocal train
        res = arena.sample(state, batch, generator=g)
        train, prios, _ = agent.learner_step(train, res.batch, w)
        arena.update_priorities(state, res.indices, prios)

    # Where a step's time goes: device-busy time per step beside wall time
    # (outside the launch count above).
    device_ms, top = _device_profile(one_step, 5)
    wall_ms = dt / (steps - warmup) * 1e3
    rec["walker_learner"].update(
        wall_ms_per_step=wall_ms,
        device_busy_ms_per_step=device_ms,
        device_idle_share=None if device_ms is None else 1 - device_ms / wall_ms,
        top_device_ms_per_step=top,
    )
    print(json.dumps(rec), flush=True)


def _cuda_vs_cpu_phase(torch, dev):
    """The port's learner on the card against itself on the CPU (small shapes)."""
    from r2d2dpg_torch.agents import R2D2DPG
    from r2d2dpg_torch.configs import PENDULUM_TINY
    from r2d2dpg_torch.models import ActorNet, CriticNet
    from r2d2dpg_torch.replay import SequenceBatch
    from r2d2dpg_torch.tree import tree_map

    cfg = PENDULUM_TINY.agent
    B, L, H = 8, cfg.seq_len, PENDULUM_TINY.hidden
    gen = torch.Generator().manual_seed(1)
    batch = SequenceBatch(
        obs=torch.randn(B, L, 3, generator=gen),
        action=torch.rand(B, L, 1, generator=gen) * 2 - 1,
        reward=torch.randn(B, L, generator=gen),
        discount=torch.ones(B, L),
        reset=(torch.rand(B, L, generator=gen) < 0.15).float(),
        carries={
            "actor": (torch.randn(B, H, generator=gen), torch.randn(B, H, generator=gen)),
            "critic": (torch.randn(B, H, generator=gen), torch.randn(B, H, generator=gen)),
        },
    )
    w = torch.rand(B, generator=gen) + 0.2
    agent = R2D2DPG(ActorNet(3, 1, hidden=H), CriticNet(3, 1, hidden=H), cfg)
    out = {}
    for d in ("cpu", dev):
        train = agent.init(torch.Generator().manual_seed(0), d)
        b = tree_map(lambda x: x.to(d), batch)
        for _ in range(3):
            train, prios, metrics = agent.learner_step(train, b, w.to(d))
        out[str(d)] = (train, prios, metrics)
    (tc, pc, mc), (tg, pg, mg) = out["cpu"], out[str(dev)]
    worst = 0.0
    for k in tc.actor_params:
        worst = max(worst, (tc.actor_params[k] - tg.actor_params[k].cpu()).abs().max().item())
    for k in tc.critic_params:
        worst = max(worst, (tc.critic_params[k] - tg.critic_params[k].cpu()).abs().max().item())
    prio_err = (pc - pg.cpu()).abs().max().item()
    metric_err = max(
        abs(float(mc[k]) - float(mg[k])) / max(1.0, abs(float(mc[k]))) for k in mc
    )
    # Same tolerance as tests/test_torch_agent.py holds the CPU path to JAX.
    if worst > 1e-4 or prio_err > 1e-3 or metric_err > 1e-3:
        raise AssertionError(
            f"card vs CPU learner: params {worst}, priorities {prio_err}, "
            f"metrics {metric_err}"
        )
    print(json.dumps({"cuda_vs_cpu_learner": {
        "steps": 3, "max_param_err": worst, "max_priority_err": prio_err,
        "max_metric_err": metric_err}}), flush=True)


def _trainer_phase(torch, dev):
    """The main path through its entry point, with launch counts around it."""
    from r2d2dpg_torch import kernels
    from r2d2dpg_torch.configs import PENDULUM_R2D2
    from r2d2dpg_torch.ops.priority import PRIORITY_EPS
    from r2d2dpg_torch.replay.arena import ReplayArena
    from r2d2dpg_torch.train import main as train_main

    train_phases = 10
    # Record what each add writes, to show that the learner's write-back
    # later moved those priorities.
    entered = torch.zeros(PENDULUM_R2D2.trainer.capacity, device=dev)
    plain_add = ReplayArena.add

    def add(self, state, batch, priorities, meta=None):
        n = priorities.shape[0]
        slots = (state.cursor + torch.arange(n, device=dev)) % self.capacity
        entered[slots] = priorities.clamp_min(PRIORITY_EPS)
        return plain_add(self, state, batch, priorities, meta)

    ReplayArena.add = add
    buf = io.StringIO()
    try:
        for k in kernels.ALL_KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            state = train_main([
                "--config", "pendulum_r2d2", "--phases", str(train_phases),
                "--log-every", "16",
            ])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels.ALL_KERNELS}
    finally:
        ReplayArena.add = plain_add
    lines = buf.getvalue().splitlines()
    expected = train_phases * PENDULUM_R2D2.trainer.learner_steps
    if launches["priority_scatter"] != expected:
        raise AssertionError(f"scatter launches {launches}, expected {expected}")
    filled = state.arena.priority > 0
    moved = int(((state.arena.priority != entered) & filled).sum())
    if moved == 0:
        raise AssertionError("no arena priority moved off its entry value")
    if not bool(torch.isfinite(state.arena.priority).all()):
        raise AssertionError("non-finite arena priorities")
    print(lines[0], flush=True)  # backend line
    print("last log line:", lines[-1], flush=True)

    # Train-phase time on the run's final state (not part of the launch count).
    trainer = PENDULUM_R2D2.build(dev)
    for _ in range(3):
        state, _ = trainer.train_phase(state)
    torch.cuda.synchronize()
    n = 20
    t1 = time.perf_counter()
    for _ in range(n):
        state, metrics = trainer.train_phase(state)
    torch.cuda.synchronize()
    phase_ms = (time.perf_counter() - t1) / n * 1e3

    def one_phase():
        nonlocal state
        state, _ = trainer.train_phase(state)

    device_ms, top = _device_profile(one_phase, 3)
    print(json.dumps({"pendulum_r2d2_trainer": {
        "train_phases": train_phases, "run_seconds": seconds,
        "train_phase_ms": phase_ms,
        "device_busy_ms_per_phase": device_ms,
        "device_idle_share": None if device_ms is None else 1 - device_ms / phase_ms,
        "top_device_ms_per_phase": top,
        "scatter_launches": launches["priority_scatter"],
        "priorities_moved": moved, "filled_slots": int(filled.sum()),
    }}), flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from r2d2dpg_torch import kernels, resolve_device

    dev = resolve_device("cuda")
    card_raw, card_name, power_limit = _card_line()
    print(card_raw, flush=True)
    print(json.dumps({"card": card_name, "power_limit": power_limit}), flush=True)

    t0 = time.perf_counter()
    kernels.build_all(kernels.ALL_KERNELS)
    for k in kernels.ALL_KERNELS:
        k.library()
    print(json.dumps({"build_seconds": time.perf_counter() - t0}), flush=True)

    max_err, t = _scatter_phase(torch, dev)
    _graph_phase(torch, dev)
    _walker_learner_phase(torch, dev)
    _cuda_vs_cpu_phase(torch, dev)
    launches = _trainer_phase(torch, dev)

    summary = {"kernels": [{
        "name": "priority_scatter",
        "route": "cuda",
        "source": "r2d2dpg_torch/csrc/priority_scatter.cu",
        "replaces": "r2d2dpg_tpu/ops/pallas/scatter.py:48",
        "launches": launches["priority_scatter"],
        "max_abs_err": max_err,
        "ms": t["kernel_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": "bytes",
        "library_ms": t["library_ms"],
        "timing": t["kernel_timing"],
        "launch_event_ms": t["kernel_event_ms"],
        "kernel_us": t["kernel_ms"] * 1e3,
        "launch_floor_us": (
            None if t["launch_floor_ms"] is None else t["launch_floor_ms"] * 1e3),
        "launch_floor_event_us": t["launch_floor_event_ms"] * 1e3,
        "plain_us": t["plain_ms"] * 1e3,
        "library_us": t["library_ms"] * 1e3,
        "library_deterministic_us": t["library_deterministic_ms"] * 1e3,
        "library_event_us": t["library_event_ms"] * 1e3,
        "card": card_name,
        "power_limit": power_limit,
    }]}
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
