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
5. learner legs at full published width, each sample -> learner_step ->
   update_priorities on synthetic sequences, metrics finite, the scatter's
   launch count set to 0 before and equal to the steps after; then two
   more steps traced for device-busy time:
   - walker_r2d2, the headline shapes (hidden 256, obs 24, act 6, batch 64,
     seq 43, capacity 100k, 4,096 resident): 120 steps, as in earlier runs;
   - walker_r2d2 with ``--twin-critic 1 --target-policy-sigma 0.2``, with
     ``--compute-dtype bfloat16``, and with all three (25 steps each);
   - humanoid_r2d2 (batch 64, seq 85, obs 67, act 21, capacity 50k, full)
     and cheetah_pixels (batch 32, seq 45, 64x64x3 uint8 frames, act 6,
     capacity 8,000, full): 45 steps each;
6. the port's learner on the card against the same learner on the CPU at
   pendulum_tiny width (the CPU path is the one held to the JAX reference
   by tests/test_torch_*.py): fp32, 36x36 pixels, twin + smoothing, bf16;
7. the main path through its entry point: ``r2d2dpg_torch.train.main`` on
   ``pendulum_r2d2`` (warm-up 4 + replay fill 50 + 10 train phases), plain
   with ``--checkpoint-dir <tmp> --checkpoint-every 5``, and with
   ``--twin-critic 1 --target-policy-sigma 0.2 --compute-dtype bfloat16``,
   with every launch count set to 0 just before and read just after each
   run;
8. checkpoints, on the plain run's final state: the latest checkpoint
   restored bitwise, a full and a light save timed; ``python -m
   r2d2dpg_torch.serve --selftest 256`` on the run's directory (every code
   ``ok``) while ``train --resume --phases 5`` continues the run there
   (its own launch count); ``eval`` of 10 episodes from the latest step;
9. serving at walker_r2d2's actor width (obs 24, act 6, hidden 256):
   one request's policy step padded to 32 rows (every step's row count),
   in a 1-row step and the plain 2-D step beside it, wall and device-busy
   ms; 64 interleaved sessions x 64 steps with a checkpoint saved
   half-way and polled every 0.25 s (every session kept, ``params_step``
   1 -> 2, latency before and from the save), each session's actions
   bitwise equal to its rollout alone and within 1e-5 of the plain
   one-row rollout (both required); two router workers on the card
   bitwise equal to one worker, no affinity violation;
10. the scatter launched on a side stream (where the pipelined learner
   launches it), bitwise against the plain version;
11. the pipeline-off anchor: ``PipelineExecutor(enabled=False)`` against
   ``Trainer.run`` at pendulum_r2d2 with ``min_replay`` cut to 40 (4 + 10
   + 6 phases) and deterministic algorithms on, bitwise or else within
   1e-5;
12. the pipelined main path: ``train.main --pipeline 1 --phases 40
   --pipeline-depth 2 --trace-sample 0.1`` at pendulum_r2d2 (warm-up 4 +
   fill 50 + 40 train phases), counts set to 0 just before and read just
   after (one launch per learner step), the run's counters, priorities
   moved and finite, the executor's stats, the sampled hop spans; then 40
   phase-locked train phases timed in the same process and device-busy
   time of 3 pipelined ones;
13. whether ``mujoco`` and ``dm_control`` import (informational);
14. each phase's seconds, one JSON line per kernel summary (launches
   summed over every path), then the last line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and nothing of ``r2d2dpg_tpu``.  Without a card,
or outside a checkout of the repo, it exits nonzero and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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
    """(device ms per call, top kernels, device events per call) over ``n``
    calls, from torch.profiler.

    Sums the durations of the device-side events (kernels, copies) CUPTI
    recorded; ``None`` when the profiler saw no device time.  Only device
    activity is traced: recording every CPU-side op as well made parsing
    the trace take longer than the learner steps it traced.
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by_name, count = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            count += 1
    total_us = sum(by_name.values())
    if total_us <= 0:
        return None, [], None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return total_us / n / 1e3, [(k[:60], v / n / 1e3) for k, v in top], count / n


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name, limit = (x.strip() for x in out.split(",", 1))
    return out, name, limit


@contextlib.contextmanager
def _deterministic(torch, on, warn_only=False):
    """``torch.use_deterministic_algorithms(on)`` inside, restored after."""
    prev = torch.are_deterministic_algorithms_enabled()
    prev_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(on, warn_only=warn_only)
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
    grid += [(p, 8_000, 32) for p in SCATTER_PATTERNS]  # cheetah_pixels
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
        ms, top, _ = _device_profile(fn, n)
        return ms, [name for name, _ in top]

    floor_ms, _ = device_ms(launch_floor, 500)

    # Timing at the learner's shapes: B sampled (in-range, duplicates
    # allowed) slots of the walker (100k), pendulum_r2d2 and humanoid (50k)
    # and cheetah_pixels (8,000, B 32) arenas.
    # The CUDA-event time per call also holds the host's launch gap; the
    # kernel, index_put_ and the launch floor take turns for it.
    g = torch.Generator(device=dev).manual_seed(0)
    timings = []
    for capacity, b in ((100_000, 64), (50_000, 64), (8_000, 32), (100_000, 256)):
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


# Observation shape, dtype and action width of each DM-Control config's env
# (the JAX package's dmc_host specs; the envs themselves are not ported).
ENV_SHAPES = {
    "walker_r2d2": ((24,), "float32", 6),
    "humanoid_r2d2": ((67,), "float32", 21),
    "cheetah_pixels": ((64, 64, 3), "uint8", 6),
}
TD3_FLAGS = ("--twin-critic", "1", "--target-policy-sigma", "0.2")
BF16_FLAGS = ("--compute-dtype", "bfloat16")


def _config(name, *flags):
    """A named config with CLI override flags applied, as the CLI does."""
    from r2d2dpg_torch.configs import get_config
    from r2d2dpg_torch.train import _apply_overrides, parse_args

    return _apply_overrides(get_config(name), parse_args(["--config", name, *flags]))


def _learner_leg(torch, dev, label, config, steps=45, warmup=5, fill=None,
                 capacity=None, chunk=2048):
    """sample -> learner_step -> update_priorities at ``config``'s published shapes.

    Synthetic sequences fill ``fill`` slots (all of them by default) of an
    arena of the config's capacity; the batch, sequence length, widths and
    knobs are the config's.  The scatter's launch count is set to 0 just
    before the timed loop and must equal its steps just after.
    """
    import types

    from r2d2dpg_torch.envs.core import EnvSpec
    from r2d2dpg_torch.kernels import PRIORITY_SCATTER
    from r2d2dpg_torch.replay import ReplayArena, SequenceBatch

    obs_shape, obs_dtype, act_dim = ENV_SHAPES[config.name]
    spec = EnvSpec(config.name, obs_shape, act_dim, pixels=config.pixels)
    agent = config.build_agent(types.SimpleNamespace(spec=spec))
    cfg = agent.config
    batch = config.trainer.batch_size
    capacity = capacity or config.trainer.capacity
    fill = capacity if fill is None else fill
    seq_len = cfg.seq_len
    g = torch.Generator(device=dev).manual_seed(0)

    def sequences(n):
        if obs_dtype == "uint8":
            obs = torch.randint(0, 256, (n, seq_len, *obs_shape), generator=g,
                                device=dev, dtype=torch.uint8)
        else:
            obs = torch.randn(n, seq_len, *obs_shape, generator=g, device=dev)
        return SequenceBatch(
            obs=obs,
            action=torch.rand(n, seq_len, act_dim, generator=g, device=dev) * 2 - 1,
            reward=torch.randn(n, seq_len, generator=g, device=dev),
            discount=torch.ones(n, seq_len, device=dev),
            reset=torch.zeros(n, seq_len, device=dev),
            carries={
                "actor": agent.actor.initial_carry(n, dev),
                "critic": agent.critic.initial_carry(n, dev),
            },
        )

    t_fill = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    arena = ReplayArena(capacity, prioritized=True)
    state = None
    for start in range(0, fill, chunk):
        seqs = sequences(min(chunk, fill - start))
        if state is None:
            state = arena.init_state(seqs)
        arena.add(state, seqs, torch.rand(seqs.reward.shape[0], generator=g, device=dev) + 0.5)
    del seqs
    arena_gb = sum(x.numel() * x.element_size() for x in (
        state.data.obs, state.data.action, state.data.reward, state.data.discount,
        state.data.reset, *state.data.carries["actor"], *state.data.carries["critic"],
    )) / 1e9
    train = agent.init(torch.Generator().manual_seed(0), dev)
    w = torch.ones(batch, device=dev)
    torch.cuda.synchronize()
    fill_seconds = time.perf_counter() - t_fill
    smoothing = cfg.target_policy_sigma > 0

    def one_step():
        nonlocal train
        res = arena.sample(state, batch, generator=g)
        normal = None
        if smoothing:
            normal = torch.randn((cfg.unroll + cfg.n_step, batch, act_dim),
                                 generator=g, device=dev)
        train, prios, metrics = agent.learner_step(train, res.batch, w, normal)
        arena.update_priorities(state, res.indices, prios)
        return metrics

    torch.cuda.synchronize()
    t_steps = time.perf_counter()
    PRIORITY_SCATTER.launches = 0
    finite = []
    for i in range(steps):
        if i == warmup:  # time the steps after the first few (allocator, cuBLAS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        metrics = one_step()
        finite.append(torch.isfinite(torch.stack(list(metrics.values()))).all())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steps_seconds = time.perf_counter() - t_steps
    launches = PRIORITY_SCATTER.launches
    if not bool(torch.stack(finite).all()):
        raise AssertionError(f"non-finite learner metrics in the {label} leg")
    if launches != steps:
        raise AssertionError(f"{label}: {launches} scatter launches for {steps} learner steps")
    rec = {
        "config": config.name,
        "twin_critic": cfg.twin_critic,
        "target_policy_sigma": cfg.target_policy_sigma,
        "compute_dtype": config.compute_dtype,
        "batch": batch, "seq_len": seq_len, "obs_shape": list(obs_shape),
        "obs_dtype": obs_dtype, "act_dim": act_dim, "hidden": config.hidden,
        "capacity": capacity, "resident": fill, "arena_gb": arena_gb,
        "steps": steps, "timed_steps": steps - warmup, "seconds": dt,
        "steps_per_s": (steps - warmup) / dt,
        "scatter_launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "last_metrics": {k: float(v) for k, v in metrics.items()},
    }

    # Where a step's time goes: device-busy time per step beside wall time
    # (outside the launch count above).  Two traced steps: device time per
    # step repeats within about 1 % from run to run, and parsing the trace
    # costs seconds a step.
    t_prof = time.perf_counter()
    device_ms, top, events = _device_profile(one_step, 2)
    wall_ms = dt / (steps - warmup) * 1e3
    rec.update(
        fill_seconds=fill_seconds, steps_seconds=steps_seconds,
        profile_seconds=time.perf_counter() - t_prof,
        wall_ms_per_step=wall_ms,
        device_busy_ms_per_step=device_ms,
        device_events_per_step=events,
        device_idle_share=None if device_ms is None else 1 - device_ms / wall_ms,
        top_device_ms_per_step=top,
    )
    print(json.dumps({f"{label}_learner": rec}), flush=True)
    return launches


def _learner_phase(torch, dev):
    """Every learner leg; returns the scatter launches of each."""
    legs = (
        # The walker leg of earlier runs, unchanged: 120 steps, 4,096 resident.
        ("walker", _config("walker_r2d2"), dict(steps=120, warmup=10, fill=4096)),
        # Its variants, read against it within the run: 20 timed steps.
        ("walker_td3", _config("walker_r2d2", *TD3_FLAGS), dict(steps=25, fill=4096)),
        ("walker_bf16", _config("walker_r2d2", *BF16_FLAGS), dict(steps=25, fill=4096)),
        ("walker_td3_bf16", _config("walker_r2d2", *TD3_FLAGS, *BF16_FLAGS),
         dict(steps=25, fill=4096)),
        ("humanoid_r2d2", _config("humanoid_r2d2"), {}),
        ("cheetah_pixels", _config("cheetah_pixels"), {}),
    )
    return {label: _learner_leg(torch, dev, label, config, **kw)
            for label, config, kw in legs}


def _card_vs_cpu(torch, dev, name, pixels=False, knobs=(), dtype="float32", steps=3):
    """One learner variant at pendulum_tiny width on the card and on the CPU."""
    import dataclasses

    from r2d2dpg_torch.agents import R2D2DPG
    from r2d2dpg_torch.configs import PENDULUM_TINY
    from r2d2dpg_torch.models import ActorNet, CriticNet
    from r2d2dpg_torch.replay import SequenceBatch
    from r2d2dpg_torch.tree import tree_map

    cfg = dataclasses.replace(PENDULUM_TINY.agent, **dict(knobs))
    B, L, H = 8, cfg.seq_len, PENDULUM_TINY.hidden
    obs_shape = (36, 36, 3) if pixels else (3,)
    gen = torch.Generator().manual_seed(1)
    if pixels:  # the smallest frame the conv stack accepts
        obs = torch.randint(0, 256, (B, L, *obs_shape), generator=gen, dtype=torch.uint8)
    else:
        obs = torch.randn(B, L, 3, generator=gen)
    batch = SequenceBatch(
        obs=obs,
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
    normals = [torch.randn(cfg.unroll + cfg.n_step, B, 1, generator=gen)
               if cfg.target_policy_sigma > 0 else None for _ in range(steps)]
    nets = dict(hidden=H, pixels=pixels, dtype=getattr(torch, dtype))
    agent = R2D2DPG(ActorNet(obs_shape, 1, **nets), CriticNet(obs_shape, 1, **nets), cfg)
    # The same learner with Adam swapped for the identity on the gradient:
    # its new optimizer states are the first step's raw gradients.
    capture = R2D2DPG(agent.actor, agent.critic, cfg)
    capture._optimize = lambda params, g, opt_state, lr: (params, g)
    out, grads, seconds = {}, {}, {}
    for d in ("cpu", dev):
        t0 = time.perf_counter()
        train = agent.init(torch.Generator().manual_seed(0), d)
        b = tree_map(lambda x: x.to(d), batch)
        first = None if normals[0] is None else normals[0].to(d)
        g = capture.learner_step(train, b, w.to(d), first)[0]
        grads[str(d)] = {"actor_params": g.actor_opt_state,
                         "critic_params": g.critic_opt_state}
        for normal in normals:
            train, prios, metrics = agent.learner_step(
                train, b, w.to(d), None if normal is None else normal.to(d))
        out[str(d)] = (train, prios, metrics)
        if d != "cpu":
            torch.cuda.synchronize()
        seconds[str(d)] = time.perf_counter() - t0
    (tc, pc, mc), (tg, pg, mg) = out["cpu"], out[str(dev)]
    rec = {"steps": steps, "cpu_seconds": seconds["cpu"], "card_seconds": seconds[str(dev)]}
    # Gradients before Adam, relative to each tensor's largest CPU gradient.
    rec["max_grad_err_rel"] = max(
        (grads[str(dev)][part][k].cpu() - g).abs().max().item()
        / (g.abs().max().item() + 1e-6)
        for part in grads["cpu"] for k, g in grads["cpu"][part].items())
    for part, lr in (("actor_params", cfg.actor_lr), ("critic_params", cfg.critic_lr)):
        errs = [(getattr(tc, part)[k] - getattr(tg, part)[k].cpu()).abs().max().item()
                for k in getattr(tc, part)]
        rec[f"max_{part}_err"] = max(errs)
        rec[f"max_{part}_err_in_lr"] = max(errs) / lr
    rec["max_priority_err"] = (pc - pg.cpu()).abs().max().item()
    rec["max_metric_err"] = max(
        abs(float(mc[k]) - float(mg[k])) / max(1.0, abs(float(mc[k]))) for k in mc)
    if dtype == "float32":
        # Same tolerance as tests/test_torch_agent.py holds the CPU path to JAX.
        ok = (max(rec["max_actor_params_err"], rec["max_critic_params_err"]) <= 1e-4
              and rec["max_priority_err"] <= 1e-3 and rec["max_metric_err"] <= 1e-3
              and rec["max_grad_err_rel"] <= 1e-3)
    else:
        # bf16, the rule tests/test_torch_mixed.py holds the CPU path to JAX
        # by.  cuBLAS and the CPU round a bf16 Dense result each to its own
        # nearest bf16 after summing in other orders, so a result near a
        # rounding boundary lands one bf16 step (2**-8 relative) apart:
        # gradients within 3 % of each tensor's largest; priorities and
        # metrics within 2 % (+1e-3).  After ONE Adam step a param moves by
        # ~sign(g) * lr, so params lie within 2.05 lr, and more than 0.01 lr
        # apart only where the CPU gradient is within those 3 % of 0 (its
        # sign is not settled at bf16).  A skipped or wrong-signed update
        # moves every settled param by ~lr or ~2 lr and fails.
        def rel(a, b):
            return (a - b).abs().max().item() / (1e-3 + 2e-2 * b.abs().max().item())
        metric_rel = max(rel(torch.tensor(float(mg[k])), torch.tensor(float(mc[k])))
                         for k in mc)
        settled_off = 0.0
        for part, lr in (("actor_params", cfg.actor_lr), ("critic_params", cfg.critic_lr)):
            for k, g in grads["cpu"][part].items():
                off = (getattr(tc, part)[k] - getattr(tg, part)[k].cpu()).abs() / lr
                settled = g.abs() > 0.03 * g.abs().max()
                if settled.any():
                    settled_off = max(settled_off, off[settled].max().item())
        rec.update(priority_rel=rel(pg.cpu(), pc), metric_rel=metric_rel,
                   max_settled_params_err_in_lr=settled_off)
        ok = (max(rec["max_actor_params_err_in_lr"],
                  rec["max_critic_params_err_in_lr"]) <= 2.05
              and settled_off <= 0.01 and rec["max_grad_err_rel"] <= 0.03
              and rec["priority_rel"] <= 1.0 and metric_rel <= 1.0)
    if not ok:
        raise AssertionError(f"card vs CPU learner ({name}): {rec}")
    return rec


def _cuda_vs_cpu_phase(torch, dev):
    """The port's learner on the card against itself on the CPU (small shapes):
    plain fp32 (3 steps), 36x36 pixels (3 steps), twin critic + smoothing
    with the same injected normal on both sides (3 steps), bf16 (1 step)."""
    td3 = (("twin_critic", True), ("target_policy_sigma", 0.2))
    print(json.dumps({"cuda_vs_cpu_learner": _card_vs_cpu(torch, dev, "fp32")}),
          flush=True)
    recs = {
        "pixels36": _card_vs_cpu(torch, dev, "pixels36", pixels=True),
        "td3": _card_vs_cpu(torch, dev, "td3", knobs=td3),
        "bf16": _card_vs_cpu(torch, dev, "bf16", dtype="bfloat16", steps=1),
    }
    print(json.dumps({"cuda_vs_cpu_learner_variants": recs}), flush=True)


@contextlib.contextmanager
def _entry_priorities(torch, dev, capacity):
    """Record what each ``ReplayArena.add`` writes (yields the ``[capacity]``
    record), to show later that the learner's write-back moved those
    priorities."""
    from r2d2dpg_torch.ops.priority import PRIORITY_EPS
    from r2d2dpg_torch.replay.arena import ReplayArena

    entered = torch.zeros(capacity, device=dev)
    plain_add = ReplayArena.add

    def add(self, state, batch, priorities, meta=None):
        n = priorities.shape[0]
        slots = (state.cursor + torch.arange(n, device=dev)) % self.capacity
        entered[slots] = priorities.clamp_min(PRIORITY_EPS)
        return plain_add(self, state, batch, priorities, meta)

    ReplayArena.add = add
    try:
        yield entered
    finally:
        ReplayArena.add = plain_add


def _priorities_moved(torch, label, state, entered):
    """Finite arena priorities, some moved off their entry values; returns
    (moved, filled)."""
    filled = state.arena.priority > 0
    moved = int(((state.arena.priority != entered) & filled).sum())
    if moved == 0:
        raise AssertionError(f"{label}: no arena priority moved off its entry value")
    if not bool(torch.isfinite(state.arena.priority).all()):
        raise AssertionError(f"{label}: non-finite arena priorities")
    return moved, int(filled.sum())


def _trainer_phase(torch, dev, label="pendulum_r2d2_trainer", flags=(), after_run=None):
    """The main path through its entry point, with launch counts around it.

    ``after_run(state)`` runs on the run's final state before the timing
    below trains it further (the checkpoint phase reads it there).
    """
    from r2d2dpg_torch import kernels
    from r2d2dpg_torch.train import main as train_main

    config = _config("pendulum_r2d2", *flags)
    train_phases = 10
    buf = io.StringIO()
    with _entry_priorities(torch, dev, config.trainer.capacity) as entered:
        for k in kernels.ALL_KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            state = train_main([
                "--config", "pendulum_r2d2", "--phases", str(train_phases),
                "--log-every", "16", *flags,
            ])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels.ALL_KERNELS}
    lines = buf.getvalue().splitlines()
    expected = train_phases * config.trainer.learner_steps
    if launches["priority_scatter"] != expected:
        raise AssertionError(f"{label}: scatter launches {launches}, expected {expected}")
    moved, filled = _priorities_moved(torch, label, state, entered)
    print(lines[0], flush=True)  # backend line
    print("last log line:", lines[-1], flush=True)
    extra = after_run(state) if after_run is not None else {}

    # Train-phase time on the run's final state (not part of the launch count).
    t_timing = time.perf_counter()
    trainer = config.build(dev)
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

    device_ms, top, events = _device_profile(one_phase, 3)
    print(json.dumps({label: {
        "flags": list(flags),
        "train_phases": train_phases, "run_seconds": seconds,
        "timing_seconds": time.perf_counter() - t_timing,
        "train_phase_ms": phase_ms,
        "device_busy_ms_per_phase": device_ms,
        "device_events_per_phase": events,
        "device_idle_share": None if device_ms is None else 1 - device_ms / phase_ms,
        "top_device_ms_per_phase": top,
        "scatter_launches": launches["priority_scatter"],
        "priorities_moved": moved, "filled_slots": filled,
    }}), flush=True)
    return {label: launches["priority_scatter"], **extra}


def _side_stream_scatter(torch, dev):
    """The scatter launched on a side stream (where the pipelined learner
    launches it), bitwise against the plain version."""
    from r2d2dpg_torch.ops.scatter import priority_scatter, priority_scatter_plain
    from r2d2dpg_torch.testing import scatter_case

    cases = []
    for seed, (pattern, capacity, b) in enumerate(
            (("mixed", 50_000, 64), ("repeat", 50_000, 256), ("all_same", 8_000, 32))):
        prio, idx, vals = (torch.from_numpy(a).to(dev)
                           for a in scatter_case(pattern, capacity, b, 100 + seed))
        want = priority_scatter_plain(prio.clone(), idx, vals)
        side = torch.cuda.Stream(dev)
        got = prio.clone()
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            priority_scatter(got, idx, vals)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"side-stream scatter != plain: {pattern}, B {b}")
        cases.append({"pattern": pattern, "capacity": capacity, "b": b,
                      "max_abs_err": (got - want).abs().max().item()})
    print(json.dumps({"priority_scatter_side_stream": cases}), flush=True)
    return max(c["max_abs_err"] for c in cases)


def _pipeline_off_anchor(torch, dev, train_phases=6, min_replay=40):
    """``PipelineExecutor(enabled=False).run`` against ``Trainer.run`` at
    pendulum_r2d2 on the card, deterministic algorithms on: bitwise, or
    else within 1e-5 of each other (the largest difference printed).
    Depth cut: ``min_replay`` 40, so 10 replay-fill phases, not 50."""
    import dataclasses
    import warnings

    from r2d2dpg_torch.training.pipeline import PipelineConfig, PipelineExecutor
    from r2d2dpg_torch.tree import tree_leaves

    config = _config("pendulum_r2d2")
    config = dataclasses.replace(config, trainer=dataclasses.replace(
        config.trainer, min_replay=min_replay))
    quiet = dict(log_every=16, log_fn=lambda *_: None)
    t0 = time.perf_counter()
    with _deterministic(torch, True, warn_only=True), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        trainer = config.build(dev)
        n = trainer.window_fill_phases + trainer.replay_fill_phases + train_phases
        ref = trainer.run(n, **quiet)
        ex = PipelineExecutor(config.build(dev), PipelineConfig(enabled=False))
        got = ex.run(n, **quiet)
        torch.cuda.synchronize()
    strip = lambda s: (s.train, s.arena, s.window, s.obs, s.env_state,  # noqa: E731
                       s.actor_carry, s.critic_carry, s.episode_return)
    pairs = list(zip(tree_leaves(strip(ref)), tree_leaves(strip(got)), strict=True))
    bitwise = all(torch.equal(a, b) for a, b in pairs)
    max_diff = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
    counters = lambda s: (s.phase_idx, s.env_steps, s.train.step,  # noqa: E731
                          s.arena.total_added)
    rec = {"config": "pendulum_r2d2", "min_replay": min_replay, "phases": n,
           "train_phases": train_phases,
           "leaves": len(pairs), "bitwise": bitwise, "max_abs_diff": max_diff,
           "counters": list(counters(got)), "seconds": time.perf_counter() - t0}
    print(json.dumps({"pipeline_off_anchor": rec}), flush=True)
    if counters(ref) != counters(got) or not (bitwise or max_diff <= 1e-5):
        raise AssertionError(f"pipeline off != Trainer.run: {rec}")


def _pipelined_phase(torch, dev, train_phases=40):
    """The pipelined main path through its entry point: ``train.main
    --pipeline 1`` at pendulum_r2d2 with the launch counts set to 0 just
    before and read just after; then the same number of phase-locked train
    phases timed in this process, and device-busy time of 3 pipelined ones."""
    import random

    from r2d2dpg_torch import kernels
    from r2d2dpg_torch.obs import get_flight_recorder
    from r2d2dpg_torch.train import main as train_main
    from r2d2dpg_torch.training.pipeline import PipelineConfig, PipelineExecutor

    label = "pendulum_r2d2_pipelined"
    config = _config("pendulum_r2d2")
    tc = config.trainer
    logdir = tempfile.mkdtemp(prefix="chip_smoke_pipeline_")
    buf = io.StringIO()
    try:
        random.seed(0)  # which batches --trace-sample picks
        get_flight_recorder().clear_spans()
        with _entry_priorities(torch, dev, tc.capacity) as entered:
            for k in kernels.ALL_KERNELS:
                k.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                state = train_main([
                    "--config", "pendulum_r2d2", "--pipeline", "1",
                    "--phases", str(train_phases), "--pipeline-depth", "2",
                    "--trace-sample", "0.1", "--log-every", "10", "--logdir", logdir,
                ])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {k.name: k.launches for k in kernels.ALL_KERNELS}
        trace_written = os.path.exists(os.path.join(logdir, "trace.json"))
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    lines = buf.getvalue().splitlines()
    trainer = config.build(dev)
    fill = trainer.window_fill_phases + trainer.replay_fill_phases
    expected = train_phases * tc.learner_steps
    if launches["priority_scatter"] != expected:
        raise AssertionError(f"{label}: scatter launches {launches}, expected {expected}")
    want = (fill + train_phases, (fill + train_phases) * tc.stride * tc.num_envs,
            train_phases * tc.learner_steps,
            min((trainer.replay_fill_phases + train_phases) * tc.num_envs, tc.capacity))
    got = (state.phase_idx, state.env_steps, state.train.step,
           trainer.arena.size(state.arena))
    if got != want:
        raise AssertionError(f"{label}: (phase, env_steps, step, arena size) {got} != {want}")
    moved, filled = _priorities_moved(torch, label, state, entered)
    stats_line = next(x for x in lines
                      if x.startswith("pipeline: ") and "overlap_fraction" in x)
    words = stats_line.split()[1:]
    stats = {k: float(v) for k, v in zip(words[::2], words[1::2])}
    spans = {}
    for sp in get_flight_recorder().spans():
        spans.setdefault(sp["hop"], []).append(sp["dur_s"] * 1e3)
    if not trace_written or "collect" not in spans:
        raise AssertionError(f"{label}: no sampled trace ({sorted(spans)})")
    last = [x for x in lines if x.startswith("phase ")][-1]
    numbers = []
    for word in last.split()[3:]:
        try:
            numbers.append(float(word.strip("()")))
        except ValueError:
            continue
    if not all(math.isfinite(x) for x in numbers):
        raise AssertionError(f"{label}: non-finite metrics: {last}")

    # The same number of phase-locked train phases on the run's final state,
    # then device-busy time of 3 pipelined train phases (two such calls,
    # the first a warm-up), both outside the launch count.
    for _ in range(3):
        state, _ = trainer.train_phase(state)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(train_phases):
        state, _ = trainer.train_phase(state)
    torch.cuda.synchronize()
    locked_ms = (time.perf_counter() - t1) / train_phases * 1e3
    ex = PipelineExecutor(trainer, PipelineConfig(enabled=True, queue_depth=2))

    def three():
        nonlocal state
        state = ex.run_train_phases(state, 3)

    device_ms, top, events = _device_profile(three, 1)
    wall_ms = stats["wall_s"] / stats["train_phases"] * 1e3
    print("pipeline stats line:", stats_line, flush=True)
    print("last log line:", last, flush=True)
    print(json.dumps({label: {
        "train_phases": train_phases, "queue_depth": 2, "trace_sample": 0.1,
        "run_seconds": seconds, "executor_stats": stats,
        "pipelined_ms_per_train_phase": wall_ms,
        "phase_locked_ms_per_train_phase": locked_ms,
        "pipelined_over_locked": wall_ms / locked_ms,
        "device_busy_ms_per_pipelined_phase": None if device_ms is None else device_ms / 3,
        "device_events_per_pipelined_phase": None if events is None else events / 3,
        "top_device_ms_per_3_phases": top,
        "peak_mem_gb": stats["peak_hbm_bytes"] / 1e9,
        "hop_spans": {h: {"count": len(v), "mean_ms": sum(v) / len(v),
                          "max_ms": max(v)} for h, v in spans.items()},
        "scatter_launches": launches["priority_scatter"],
        "priorities_moved": moved, "filled_slots": filled,
    }}), flush=True)
    return {label: launches["priority_scatter"]}


def _flat(tree, path=""):
    """A ``to_tree`` output as {path: leaf}."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_flat(v, f"{path}/{k}"))
        return out
    return {path: tree}


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _checkpoint_phase(torch, dev, ckdir, state):
    """On the final state of the pendulum_r2d2 run that saved into ``ckdir``
    every 5 phases: restore it (bitwise against the run's state), time a
    full and a light save, then run ``python -m r2d2dpg_torch.serve
    --selftest 256`` on ``ckdir`` while ``train --resume --phases 5`` writes
    newer steps into it, then ``eval`` 10 episodes from its latest step.
    Returns the resume run's scatter launches."""
    from r2d2dpg_torch import kernels
    from r2d2dpg_torch.eval import main as eval_main
    from r2d2dpg_torch.train import main as train_main
    from r2d2dpg_torch.utils.checkpoint import CheckpointManager, resume_state, to_tree

    config = _config("pendulum_r2d2")
    ckpt = CheckpointManager(ckdir)
    if ckpt.latest_step != state.phase_idx:
        raise AssertionError(f"latest checkpoint {ckpt.latest_step}, run ended at "
                             f"phase {state.phase_idx}")
    trainer = config.build(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = resume_state(trainer, ckpt)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    want, got = _flat(to_tree(state)), _flat(to_tree(restored))
    if want.keys() != got.keys():
        raise AssertionError(f"restored tree differs: {sorted(want.keys() ^ got.keys())}")
    differ = [k for k in want if not (
        torch.equal(want[k], got[k]) if isinstance(want[k], torch.Tensor)
        else want[k] == got[k])]
    if differ:
        raise AssertionError(f"restored leaves differ from the saved state: {differ[:8]}")
    del restored
    scratch = tempfile.mkdtemp(prefix="chip_smoke_saves_")
    try:
        save_s = {}
        for kind, light in (("full", False), ("light", True)):
            mgr = CheckpointManager(os.path.join(scratch, kind), light=light)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.save(state.phase_idx, state)
            save_s[kind] = time.perf_counter() - t0
        step_bytes = {kind: _dir_bytes(os.path.join(scratch, kind)) for kind in save_s}
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    rec = {"saved_step": state.phase_idx, "leaves_bitwise_equal": len(want),
           "restore_seconds": restore_s, "full_save_seconds": save_s["full"],
           "light_save_seconds": save_s["light"], "full_step_bytes": step_bytes["full"],
           "light_step_bytes": step_bytes["light"], "dir_bytes": _dir_bytes(ckdir),
           "steps_kept": ckpt.all_steps()}

    # The serve CLI on the run's directory while a resumed run writes to it.
    here = os.path.dirname(os.path.abspath(__file__))
    t_serve = time.perf_counter()
    serve = subprocess.Popen(
        [sys.executable, "-m", "r2d2dpg_torch.serve", "--config", "pendulum_r2d2",
         "--checkpoint-dir", ckdir, "--selftest", "256", "--poll-every", "0.5"],
        cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        for k in kernels.ALL_KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            resumed = train_main(["--config", "pendulum_r2d2", "--phases", "5",
                                  "--log-every", "16", "--checkpoint-dir", ckdir,
                                  "--checkpoint-every", "5", "--resume"])
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        resume_launches = kernels.PRIORITY_SCATTER.launches
        out, err = serve.communicate(timeout=600)
    finally:
        if serve.poll() is None:
            serve.kill()
            serve.wait()
    serve_s = time.perf_counter() - t_serve
    if (resumed.phase_idx, resumed.train.step) != (state.phase_idx + 5, state.train.step + 5):
        raise AssertionError(f"resume: phase {resumed.phase_idx}, learner step "
                             f"{resumed.train.step} after {state.phase_idx}, {state.train.step}")
    if resume_launches != 5 * config.trainer.learner_steps:
        raise AssertionError(f"resume: {resume_launches} scatter launches for 5 phases")
    if serve.returncode != 0:
        raise AssertionError(f"serve CLI exited {serve.returncode}: {err[-2000:]}")
    selftest = json.loads(out.strip().splitlines()[-1])
    if selftest["codes"] != {"ok": 256}:
        raise AssertionError(f"serve CLI selftest codes {selftest['codes']}")
    rec.update(resume_lines=buf.getvalue().splitlines()[:2], resume_seconds=resume_s,
               resumed_phase=resumed.phase_idx, resumed_learner_step=resumed.train.step,
               resume_scatter_launches=resume_launches, latest_step=ckpt.latest_step)
    print(json.dumps({"pendulum_r2d2_checkpoint": rec}), flush=True)
    print(json.dumps({"serve_cli_selftest": {
        "seconds": serve_s, "backend": err.strip().splitlines()[-1],
        **{k: selftest[k] for k in ("codes", "params_step", "requests_ok",
                                    "latency_p50_ms", "latency_p99_ms", "step_p50_ms",
                                    "step_p99_ms", "sessions_active")}}}), flush=True)

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = eval_main(["--config", "pendulum_r2d2", "--checkpoint-dir", ckdir,
                             "--episodes", "10"])
    torch.cuda.synchronize()
    rounds = [json.loads(x) for x in buf.getvalue().splitlines()[:-1]]
    if not all(math.isfinite(r[k]) for r in rounds
               for k in ("eval_return_mean", "eval_return_min", "eval_return_max")):
        raise AssertionError(f"eval: non-finite returns {rounds}")
    print(json.dumps({"pendulum_r2d2_eval": {
        "seconds": time.perf_counter() - t0, **rounds[0],
        "checkpoint_step": summary["checkpoint_step"]}}), flush=True)
    return {"pendulum_r2d2_resume": resume_launches}


SERVE_MAX_BATCH = 32  # the largest of the serve CLI's default buckets
SERVE_POLL_S = 0.25  # checkpoint polls; the serve CLI's default is 2 s
SERVE_PLAIN_ATOL = 1e-5  # served actions vs the plain one-row rollout


def _wall_ms(torch, fn, n):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def _drive(service, obs, on_step=None, latencies=None):
    """Every session's step t submitted together, t = 0, 1, ...; returns
    {session: [(params_step, action), ...]} and appends step t's request
    latencies (s) to ``latencies`` when given."""
    served = {s: [] for s in obs}
    for t in range(len(next(iter(obs.values())))):
        if on_step is not None:
            on_step(t)
        pending = [(s, service.act_async(s, obs[s][t], reset=(t == 0))) for s in obs]
        for s, req in pending:
            if not req.wait(120.0) or req.code != "ok":
                raise AssertionError(f"serving: request of {s} at step {t}: {req.code}")
            served[s].append((req.params_step, req.action))
        if latencies is not None:
            latencies.append([req.latency_s for _, req in pending])
    return served


def _latency_ms(per_step):
    """Nearest-rank p50/p99 (ms) of the requests of ``per_step``'s steps."""
    from r2d2dpg_torch.utils.metrics import PercentileWindow

    lat = [x for step in per_step for x in step]
    win = PercentileWindow(len(lat))
    for x in lat:
        win.add(x * 1e3)
    return win.percentiles((50.0, 99.0))


def _serving_phase(torch, dev, sessions=64, steps=64):
    """The serving stack at walker_r2d2's actor width (obs 24, act 6, hidden
    256, LSTM), 1,024 session rows, batches of up to 32 requests (every step
    at 32 rows), params from the port's light checkpoints of ``agent.init``,
    polled every 0.25 s."""
    import types

    import numpy as np

    from r2d2dpg_torch.envs.core import EnvSpec
    from r2d2dpg_torch.models import policy_step_fn
    from r2d2dpg_torch.serving import (
        CheckpointHotReloader,
        PolicyService,
        actor_params_template,
        build_router,
    )
    from r2d2dpg_torch.serving.service import expand_rows, rowwise_policy_step_fn
    from r2d2dpg_torch.utils.checkpoint import CheckpointManager

    obs_shape, _, act_dim = ENV_SHAPES["walker_r2d2"]
    agent = _config("walker_r2d2").build_agent(
        types.SimpleNamespace(spec=EnvSpec("walker_r2d2", obs_shape, act_dim)))
    actor = agent.actor
    train = {v: agent.init(torch.Generator().manual_seed(v), dev) for v in (1, 2)}
    kw = dict(obs_shape=obs_shape, max_sessions=1024, max_batch=SERVE_MAX_BATCH,
              flush_ms=2.0, max_queue=4096, device=dev)
    rng = np.random.default_rng(0)
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        mgr = CheckpointManager(ckdir, save_every=1, light=True)
        mgr.save(1, types.SimpleNamespace(train=train[1]))
        template = actor_params_template(actor)
        reloader = CheckpointHotReloader(ckdir, template, device=dev,
                                         poll_every_s=SERVE_POLL_S)
        svc = PolicyService(actor, reloader=reloader, **kw)
        svc.warmup()

        # One request padded to a 32-row step (before the worker starts),
        # the same request in a 1-row step (what padding costs), and the
        # plain 2-D step at 32 rows (what the row-wise form costs).
        steps_rec = {}
        obs1 = [rng.standard_normal(obs_shape).astype(np.float32)]
        one = PolicyService(actor, train[1].actor_params, **{**kw, "max_batch": 1})
        for key, service in (("1_padded_to_32", svc), ("1_at_own_size", one)):
            fn = (lambda service=service: service.policy_step([0], [1.0], obs1))
            dev_ms, top, events = _device_profile(fn, 5)
            steps_rec[key] = {"wall_ms": _wall_ms(torch, fn, 100), "device_busy_ms": dev_ms,
                              "device_events": events, "top_device_ms": top}
        plain = policy_step_fn(actor)
        x32 = torch.randn(32, *obs_shape, device=dev)
        c32 = actor.initial_carry(32, dev)
        r32 = torch.ones(32, device=dev)
        fn = (lambda: plain(train[1].actor_params, x32, c32, r32)[0].cpu())
        dev_ms, top, events = _device_profile(fn, 5)
        steps_rec["32_plain_2d"] = {"wall_ms": _wall_ms(torch, fn, 100),
                                    "device_busy_ms": dev_ms, "device_events": events,
                                    "top_device_ms": top}
        print(json.dumps({"serving_policy_step": steps_rec}), flush=True)

        # 64 sessions x 64 steps, a new checkpoint landing half-way.
        obs = {f"session-{i}": rng.standard_normal((steps,) + obs_shape).astype(np.float32)
               for i in range(sessions)}

        saved_at = []

        def on_step(t):
            if t == steps // 2:
                mgr.save(2, types.SimpleNamespace(train=train[2]))
                saved_at.append(time.perf_counter())
            elif t == steps - 1:
                # The last step must see the new params: a host fast enough
                # to finish the stream inside one poll period waits it out.
                time.sleep(max(0.0, saved_at[0] + 1.5 * SERVE_POLL_S - time.perf_counter()))

        latencies = []
        t0 = time.perf_counter()
        with svc:
            served = _drive(svc, obs, on_step, latencies)
            health = svc.health()
        serve_s = time.perf_counter() - t0
        reload_step = min(t for rows in served.values()
                          for t, (ps, _) in enumerate(rows) if ps == 2)
        before_p50, before_p99 = _latency_ms(latencies[:steps // 2])
        after_p50, after_p99 = _latency_ms(latencies[steps // 2:])
        for s, rows in served.items():
            seen = [ps for ps, _ in rows]
            if seen[0] != 1 or seen[-1] != 2 or seen != sorted(seen):
                raise AssertionError(f"serving: params steps of {s}: {seen}")
        if (health.requests_ok, health.sessions_active, health.params_step,
                health.worker_errors) != (sessions * steps, sessions, 2, 0):
            raise AssertionError(f"serving health: {health}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        CheckpointHotReloader(ckdir, template, device=dev).load_latest()
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3

        # Each session alone in row 0 of 32-row steps, against its served
        # actions (bitwise, required); a plain one-row rollout beside it.
        step = rowwise_policy_step_fn(actor)
        row_params = {v: expand_rows(t.actor_params, svc.step_rows) for v, t in train.items()}
        max_diff, plain_diff, bitwise = 0.0, 0.0, True
        t_ref = time.perf_counter()
        for s, rows in served.items():
            carry = actor.initial_carry(svc.step_rows, dev)
            carry1 = actor.initial_carry(1, dev)
            for t, (ps, action) in enumerate(rows):
                o = np.zeros((svc.step_rows,) + obs_shape, np.float32)
                o[0] = obs[s][t]
                o = torch.from_numpy(o).to(dev)
                r = torch.ones(svc.step_rows, device=dev)
                r[0] = float(t == 0)
                want, carry = step(row_params[ps], o, carry, r)
                want = want[0].cpu().numpy()
                bitwise = bitwise and np.array_equal(action, want)
                max_diff = max(max_diff, float(np.abs(action - want).max()))
                a1, carry1 = plain(train[ps].actor_params, o[:1], carry1, r[:1])
                plain_diff = max(plain_diff, float(np.abs(action - a1[0].cpu().numpy()).max()))
        ref_s = time.perf_counter() - t_ref
        if not bitwise:
            raise AssertionError(f"serving: batched != sequential rows, max abs {max_diff}")
        # The independent reading: the plain one-row step (no row-wise
        # form), with actions of about 0.1 in size.
        if not plain_diff <= SERVE_PLAIN_ATOL:
            raise AssertionError(f"serving: served actions differ from the plain "
                                 f"one-row rollout by {plain_diff} > {SERVE_PLAIN_ATOL}")
        print(json.dumps({"serving_sessions": {
            "sessions": sessions, "steps": steps, "seconds": serve_s,
            "requests_per_s": sessions * steps / serve_s, "poll_every_s": SERVE_POLL_S,
            "saved_before_step": steps // 2, "first_step_on_new_params": reload_step,
            "latency_p50_ms_before_save": before_p50, "latency_p99_ms_before_save": before_p99,
            "latency_p50_ms_from_save": after_p50, "latency_p99_ms_from_save": after_p99,
            "latency_p50_ms": health.latency_p50_ms, "latency_p99_ms": health.latency_p99_ms,
            "step_p50_ms": health.step_p50_ms, "step_p99_ms": health.step_p99_ms,
            "batch_occupancy": health.batch_occupancy, "requests_ok": health.requests_ok,
            "sessions_active": health.sessions_active, "params_step": health.params_step,
            "reload_restore_ms": restore_ms, "bitwise": bitwise, "max_abs_diff": max_diff,
            "plain_one_row_max_abs_diff": plain_diff, "plain_one_row_atol": SERVE_PLAIN_ATOL,
            "reference_seconds": ref_s,
        }}), flush=True)

        # Two workers behind the router on the one card, against one worker.
        small = {s: obs[s][:16] for s in list(obs)[:32]}
        small_steps = len(next(iter(small.values())))
        with PolicyService(actor, train[1].actor_params, **kw) as single:
            want = _drive(single, small)
        router = build_router(actor, num_workers=2, params=train[1].actor_params,
                              **{k: v for k, v in kw.items() if k != "device"},
                              device=dev)
        with router:
            got = _drive(router, small)
            rh = router.health()
        equal = all(np.array_equal(a, b) for s in small
                    for (_, a), (_, b) in zip(got[s], want[s]))
        if not equal or rh["affinity_violations"] != 0:
            raise AssertionError(f"router: bitwise {equal}, health {rh}")
        print(json.dumps({"serving_router": {
            "workers": rh["workers"], "devices": [str(x.device) for x in router.services],
            "sessions": len(small), "steps": small_steps, "affinity_violations": 0,
            "bitwise_equal_one_worker": True, "requests_ok": rh["requests_ok"],
            "per_worker_requests_ok": {w: h["requests_ok"] for w, h in rh["per_worker"].items()},
        }}), flush=True)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)


def _mujoco_probe():
    """Whether ``mujoco`` and ``dm_control`` import here, with their versions.

    Informational (the DM-Control env path needs both); no phase depends on
    it and it fails nothing.  Each import runs in a child process.
    """
    found = {}
    for mod in ("mujoco", "dm_control"):
        code = (f"import importlib.metadata as m, {mod}; "
                f"print(getattr({mod}, '__version__', None) or m.version('{mod}'))")
        try:
            r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                               text=True, timeout=120)
        except subprocess.TimeoutExpired:
            found[mod] = {"imports": False, "error": "import timed out after 120 s"}
            continue
        if r.returncode == 0:
            found[mod] = {"imports": True, "version": r.stdout.strip()}
        else:
            err = (r.stderr.strip().splitlines() or ["?"])[-1]
            found[mod] = {"imports": False, "error": err}
    print(json.dumps({"mujoco_probe": found}), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from r2d2dpg_torch import kernels, resolve_device

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    card_raw, card_name, power_limit = _card_line()
    print(card_raw, flush=True)
    print(json.dumps({"card": card_name, "power_limit": power_limit}), flush=True)

    t0 = time.perf_counter()
    kernels.build_all(kernels.ALL_KERNELS)
    for k in kernels.ALL_KERNELS:
        k.library()
    print(json.dumps({"build_seconds": time.perf_counter() - t0}), flush=True)

    phase_seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_seconds[name] = time.perf_counter() - t
        return out

    max_err, t = timed("scatter", _scatter_phase, torch, dev)
    timed("cuda_graph", _graph_phase, torch, dev)
    launches = timed("learner_legs", _learner_phase, torch, dev)
    timed("cuda_vs_cpu", _cuda_vs_cpu_phase, torch, dev)
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        launches.update(timed(
            "trainer", _trainer_phase, torch, dev, "pendulum_r2d2_trainer",
            ("--checkpoint-dir", ckdir, "--checkpoint-every", "5"),
            lambda state: timed("checkpoint_serve_cli_eval", _checkpoint_phase,
                                torch, dev, ckdir, state)))
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    phase_seconds["trainer"] -= phase_seconds["checkpoint_serve_cli_eval"]
    launches.update(timed(
        "trainer_td3_bf16", _trainer_phase,
        torch, dev, "pendulum_r2d2_td3_bf16_trainer", (*TD3_FLAGS, *BF16_FLAGS)))
    timed("serving", _serving_phase, torch, dev)
    side_err = timed("side_stream_scatter", _side_stream_scatter, torch, dev)
    timed("pipeline_off_anchor", _pipeline_off_anchor, torch, dev)
    launches.update(timed("pipelined", _pipelined_phase, torch, dev))
    timed("mujoco_probe", _mujoco_probe)
    phase_seconds["total"] = time.perf_counter() - t_start
    print(json.dumps({"phase_seconds": phase_seconds}), flush=True)

    summary = {"kernels": [{
        "name": "priority_scatter",
        "route": "cuda",
        "source": "r2d2dpg_torch/csrc/priority_scatter.cu",
        "replaces": "r2d2dpg_tpu/ops/pallas/scatter.py:48",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": max(max_err, side_err),
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
