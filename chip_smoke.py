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
4b. the LSTM recurrence kernel (``csrc/lstm_seq.cu``) against its plain
   version at the learner paths' shapes (walker, cheetah, humanoid's
   85-step window, pendulum at hidden 128 and 32, TD3's 4 members, batches
   of 1, 33, 256, 1,024 and 4,096), forward and backward after a
   synchronize; captured in a CUDA graph and replayed (bitwise the eager
   launches); hidden size 64 refused; its launch count;
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
7b. telemetry: ``train.main --config pendulum_r2d2 --phases 12 --log-every 1
   --obs-port 0 --obs-host 127.0.0.1 --profile-window 4:3
   --device-peak-flops 6.7e13`` (the H100 SXM's dense fp32 peak), counts set
   to 0 just before; a thread GETs ``/metrics``, ``/metrics.json``,
   ``/health`` and ``/healthz`` every 0.25 s: every scrape 200, every
   ``/metrics`` line a comment or ``name{labels} value``, ``/health`` ok,
   ``r2d2dpg_device_mfu`` in (0, 1.05] and the HBM gauge of device 0 on the
   scrape after the run; ``r2d2dpg_device_learn_flops_total`` equal to the
   FLOPs of a train phase times the 12 phases; the scatter launched once
   per learner step, and its kernel in the profile window's trace exactly
   3 x ``learner_steps`` times; ``profile_start`` at phase 4 and
   ``profile_stop`` at phase 7; ``python -m r2d2dpg_torch.obs.flight merge``
   fuses one ``profile_window`` span; then ``flops_of`` of one
   pendulum_tiny learner step equal on the card and on the CPU;
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
   moved and finite, the executor's stats, the sampled hop spans, every
   train phase k on the params after ``max(0, k - 3)`` drains; then 40
   phase-locked train phases timed in the same process and device-busy
   time of 3 pipelined ones;
13. the actor fleet: ``train.main --config pendulum_r2d2 --actors 3
   --phases 240`` with the learner on the card and 3 supervised actor
   subprocesses on the CPU (``--device cpu``, no card visible), one actor
   killed after 20 learner steps (exactly one restart required), counts
   set to 0 just before and read just after (one launch per learner
   step), one compute process on the card (nvidia-smi) and no actor
   holding a card device file; the f32 leg serves ``/health`` (polled
   every 0.2 s; whether ``actors_down`` showed during the killed actor's
   restart is recorded, not held); the same with ``--fleet-wire bf16
   --fleet-compress zlib --drain-coalesce 2``; then ``FleetLearner``'s
   drain fed the same recorded batches (from the port's actor in a thread,
   on the CPU, through the f32 wire codec) on the card and on the CPU,
   params within 1e-4, and device-busy time of a drain-learn phase;
   before that drain check, the chaos drills on the central drain
   (``fleet_chaos``): ``--actors 3 --phases 240 --seed 3 --fleet-heartbeat
   2.5 --chaos-spec kill_actor@p5,corrupt_frame@p8,stall_actor@p12:7s,
   kill_ingest_conn@p18 --obs-fleet 1``,
   each fault injected once (one ``chaos_inject`` line in the dumps that
   ``python -m r2d2dpg_torch.obs.flight merge`` fuses) and followed by its
   recovery (``actor_crash`` then ``actor_restart``; ``peer_dead`` then
   ``actor_reconnect``; a ``FrameCRCError`` ``ingest_conn_error`` then
   ``actor_reconnect``; ``actor_reconnect``), the learner's drill counter
   1 for each fault it fires, no ``chaos_unfired``, env steps never down,
   one compute process on the card, one scatter launch per learner step,
   and the actor-side drill counts of ``stall_actor`` and
   ``corrupt_frame`` (1 each) read off the learner's final scrape through
   the TELEM mirror;
13b. the autoscaled fleet (``fleet_autoscale``): ``train.main --actors 2
   --phases 300 --obs-fleet 1 --obs-port 0 --autoscale 1 --autoscale-every
   0.5 --autoscale-fire 2 --autoscale-cooldown 12 --health-stale-after 6
   --fleet-heartbeat 2.5 --chaos-spec kill_actor@p5,stall_actor@p70:20s``,
   the supervisor in policy mode: the kill followed by ``actor_crash``, a
   fired ``autoscale_decision`` (rule ``actors_down``), an ``actor_spawn``
   with ``origin="autoscale"`` and an ``autoscale_action`` ``spawn_actor``;
   the stall by a fired ``telem_stale`` decision, the spawn and an
   ``autoscale_action`` ``replace_actor`` of the stalled actor;
   ``r2d2dpg_autoscale_actions_total`` moved by 1 for each kind, no ladder
   restart, 2 actors alive and a final ``/health`` naming neither
   ``actors_down`` nor ``telem_stale``, env steps never down, no shed;
   ``/metrics`` polled every 0.5 s holds both actors' series under
   ``actor=``/``host=`` with TELEM staleness under 3 s outside the faults
   (each fault's window: its injection to its successor's first SEQS)
   from both actors' first SEQS to the last learner step;
   one scatter launch per learner step, one compute process on the card;
   it prints each fault's seconds to its action and to the first SEQS;
14. in-network sampling: ``train.main --config pendulum_r2d2 --actors 3
   --replay-shards 2 --phases 60`` (the in-learner loopback shards), then
   the same with ``--shard-procs 2 --phases 600 --chaos-spec
   kill_shard@p20 --obs-fleet 1`` (two supervised shard processes on the CPU; the chaos
   engine kills the targeted one after 20 learner steps, the longer run
   leaving room for its restart: one ``chaos_inject``, exactly one
   ``shard_dead``, one restart and one ``shard_rejoin`` under epoch 2
   required, every pull while it is down drawn from the survivor), then
   the direct data plane under chaos (``direct_chaos``: ``--shard-procs 2
   --shard-direct 1 --phases 200 --chaos-spec partition_data_plane@p30,
   stall_shard@p40:2s,partition_shard@p20,stall_sampler@p30:1s,
   kill_sampler_conn@p40``: every actor dials its shard, the learner
   forwards 0 bytes until the partition, which falls back and re-dials
   with the control connection whole, ``partition_shard`` reconnects
   under the same epoch with no restart, the stalls cost no shed and no
   reap, the dropped actor reconnects, env steps never go down), counts
   set to 0 just before and read just after each run (the scatter must
   launch 0 times: no device arena on this path), sheds and evictions 0,
   one compute process on the card and no actor or shard process holding
   a card device file; the shard-procs leg serves ``/health`` (polled every
   0.2 s: ``shards_down`` at 1 of 2 between the kill and the rejoin) and
   ends with ``health_final.json`` naming neither ``shards_down`` nor
   ``actors_down`` and ``metrics_final.prom`` holding
   ``r2d2dpg_shard_alive 2``; it also polls ``/metrics`` every 0.5 s: both
   shard processes' series under ``shard=``/``host=``, each
   ``r2d2dpg_shard_telem_staleness_seconds`` under 3 s while both
   processes are up and the learner pulls, the killed one's over 3 s
   during the outage and under 3 s again after its epoch-2 rejoin; then
   pulled batches at ``--learner-steps 4``
   learned on the card and on the CPU from the same params, params and
   priorities within 1e-4 of each tensor's largest value, and device-busy
   time of a whole pull-learn phase;
14a. the multi-device legs, after every other leg, each on a process
   group of one over NCCL that it tears down after it: ``learner_dp1``,
   ``DPLearnerTrainer`` at the walker shapes beside the plain ``Trainer``
   on an identical arena with the same draws, 45 learner steps each (timed
   in turns): params and priorities bitwise equal, one scatter launch per
   dp step, NCCL kernels on the card's timeline, device and wall ms beside
   the plain learner's; ``train.main --config pendulum_r2d2 --phases 10
   --log-every 16`` with ``--spmd 1`` (``spmd1``), then with
   ``--learner-dp 1`` (``learner_dp1_cli``): the ``topology:`` stamp
   printed and written to ``topology.txt``, one scatter launch per learner
   step, the params and priorities bitwise the plain run of 7's, the dp
   gauge ``r2d2dpg_dp_shard_occupancy{shard="0"}`` equal to the arena's
   size; the fleet into the dp learner (``fleet_dp1``): ``train.main
   --actors 2 --learner-dp 1 --phases 20 --profile-window 4:3``, every
   staged batch through ``DPLearnerTrainer._put_staged`` and through rank
   0's broadcast path (one control record and one payload broadcast per
   absorb and per drain-learn, one STOP), one scatter launch per
   drain-learn step, the topology stamp, the dp gauges at the drain width
   and the arena's size, NCCL kernels and the host-side ``nccl:*`` ops in
   the profile window; the sampler into the dp learner (``sampler_dp1``):
   ``--actors 2 --replay-shards 2 --learner-dp 1 --phases 10``, every
   pulled batch through ``_put_staged(axis=1)`` and the priority gather,
   one record and one payload per pull-learn and the STOP, 0 scatter
   launches, its pull-learn rate beside the loopback leg's; the
   lifecycle (``mesh_lifecycle1``), with ``--learner-dp 1`` then ``--spmd
   1`` and ``--min-replay 100`` (depth cut): ``--checkpoint-every 5
   --eval-every 5 --phases 10``, then
   ``--resume --phases 5``, bitwise the uninterrupted 15-phase run's
   params, priorities and eval lines (the resumed run's eval against an
   ``Evaluator`` on the final params with a fresh eval stream), save and
   restore seconds, checkpoint bytes;
14b. the host-pool trainer (``hybrid1``, after the mesh legs):
   ``HostSPMDTrainer`` at walker_r2d2's published width (64 envs, stride
   20, 4 learner steps a phase, batch 64, hidden 256, seq 43, capacity
   100k, ``min_replay`` 2,000) on the host stand-in env
   (``r2d2dpg_torch/testing.py::HostStandInEnv``: walker-walk's spec,
   fixed numpy dynamics, no physics): (a) ``build_spmd`` on a process
   group of one over NCCL, warm-up, fill and 10 train phases, params and
   priorities bitwise the plain ``Trainer``'s on the same stand-in and
   seed; (b) ``build`` with ``overlap_learner`` (a mesh of one), 10 train
   phases, every substep sampling the arena as of the previous emit, then
   3 phases each with overlap off, on, on, off on the same trainer (the
   like-for-like ratio); (c) ``PipelineExecutor`` over (b)'s trainer with
   overlap off, 10 phases; (d) ``hybrid1_pipelined_mesh``:
   ``PipelineExecutor(queue_depth=2)`` over ``build_spmd`` on a process
   group of one over NCCL (``--spmd D --pipeline 1``'s path at D = 1),
   10 train phases twice from one state, the two runs' params and
   priorities bitwise equal, no ``torch.distributed`` collective on the
   collector thread; each with the counts set to 0 just before and
   read just after: one scatter launch per learner step, ``train.step`` 4
   and ``env_steps`` 20 x 64 per phase, 20 host steps per phase, finite
   metrics, and for (c) and (d) every phase k on the params after
   ``max(0, k - 3)`` drains with no refresh waiting; wall and device-busy
   ms per train phase, the idle share, the host-step p50/p99, (c)'s and
   (d)'s ``overlap_fraction`` and (d)'s queue waits p50/p99.  The fleet legs
   (``fleet_f32``, ``fleet_autoscale``) print a ``<label>_drain_stalls``
   record beside their sheds: every drain-learn iteration of 0.5 s or
   more, with its segments, the learner thread's and the process's CPU
   time and sampled stacks (``fleet/ingest.py::_StallClock``);
15. whether ``mujoco`` and ``dm_control`` import (informational);
16. each phase's seconds, one JSON line per kernel summary (launches
   summed over every main path and by path, and the scatter's mean CUPTI
   µs inside the telemetry run's profile window), then the last line
   ``{"ok": true, "device": {...}}``.  Every path of 5–14 that returns
   launch counts also counts the LSTM kernel's (``_lstm_check``): a
   float32 LSTM learner launches it once forward a sequence unroll and
   three times backward a learner-step body, a bf16 one never; a path that
   misses fails the run here, after every path has run.

It imports nothing of JAX and nothing of ``r2d2dpg_tpu``.  Without a card,
or outside a checkout of the repo, it exits nonzero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import math
import os
import re
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


def _device_profile(fn, n, match=None):
    """(device ms per call, top kernels, device events per call) over ``n``
    calls, from torch.profiler; with ``match`` (name -> predicate on a
    lowercased event name) a fourth item: for each, the matching events'
    count and ms per call.

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
    matched = {k: [0, 0.0] for k in (match or {})}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            by_name[e.name] = by_name.get(e.name, 0.0) + us
            count += 1
            for k, pred in (match or {}).items():
                if pred(e.name.lower()):
                    matched[k][0] += 1
                    matched[k][1] += us
    total_us = sum(by_name.values())
    matched = {k: {"count_per_call": c / n, "ms_per_call": us / n / 1e3}
               for k, (c, us) in matched.items()}
    if total_us <= 0:
        return (None, [], None) + ((matched,) if match else ())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out = (total_us / n / 1e3, [(k[:60], v / n / 1e3) for k, v in top], count / n)
    return out + ((matched,) if match else ())


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


def _lstm_seq_phase(torch, dev):
    """The LSTM recurrence kernel (``csrc/lstm_seq.cu``) against its plain
    version at every shape of ``LSTM_SEQ_SHAPES``, forward and backward,
    each checked after ``torch.cuda.synchronize()``; captured in a CUDA
    graph and replayed on fresh inputs (bitwise the eager launches); a
    shape it does not take raises.  Prints each shape's largest gaps and the
    launch count; returns the largest gap."""
    from r2d2dpg_torch.kernels import LSTM_SEQ
    from r2d2dpg_torch.ops.lstm_seq import lstm_seq_fwd
    from r2d2dpg_torch.testing import (
        LSTM_SEQ_SHAPES,
        lstm_seq_errors,
        lstm_seq_faults,
        lstm_seq_graph_replays,
    )

    before = LSTM_SEQ.launches
    cases = []
    for seed, (label, e, t, b, h) in enumerate(LSTM_SEQ_SHAPES):
        errs = lstm_seq_errors(e, t, b, h, seed, dev)
        torch.cuda.synchronize()
        faults = lstm_seq_faults(errs)
        if faults:
            raise AssertionError(f"lstm_seq kernel != plain at {label}: {faults} {errs}")
        cases.append({"shape": label, "e": e, "t": t, "b": b, "h": h,
                      "max_gap": max(v for k, v in errs.items() if k.endswith("_gap")),
                      "max_f64_kernel": max(v for k, v in errs.items()
                                            if k.endswith("_f64_kernel")),
                      "max_f64_plain": max(v for k, v in errs.items()
                                           if k.endswith("_f64_plain"))})
    if lstm_seq_graph_replays(dev) != [True, True]:
        raise AssertionError("lstm_seq graph replay != eager launches")
    z = lambda *shape: torch.zeros(shape, device=dev)  # noqa: E731
    try:
        lstm_seq_fwd(z(1, 4, 8, 256), z(1, 256, 64), z(1, 256), z(1, 8, 64), z(1, 8, 64),
                     torch.zeros(4, 8, dtype=torch.bool, device=dev), False)
    except ValueError as err:
        refused = str(err)
    else:
        raise AssertionError("lstm_seq kernel took hidden size 64")
    print(json.dumps({"lstm_seq_cases": cases, "lstm_seq_refused": refused,
                      "lstm_seq_launches": LSTM_SEQ.launches - before}), flush=True)
    return max(c["max_gap"] for c in cases)


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


# Each main path's launches of the LSTM recurrence kernel, by the labels of
# the scatter's ``launches_by_path`` (finer where a leg runs several), and
# the paths whose count missed what the registry's counters ask.
LSTM_LAUNCHES = {}
LSTM_MISSES = []


def _float32_lstm(config) -> bool:
    """The config's nets unroll the LSTM in float32: the kernel's route."""
    return config.core == "lstm" and config.use_lstm and config.compute_dtype == "float32"


def _lstm_mark():
    """``(LSTM_SEQ launches, float32 sequence unrolls of the LSTM nets,
    learner-step bodies run on a card)`` in this process so far.  The
    last two from the registry: ``r2d2dpg_lstm_unroll_total{form="sequence",
    reason="float32"}``, and ``r2d2dpg_learner_graph_total`` at two bodies
    a capture (its warm-up and the capture), one an eager call off the CPU
    and none a replay."""
    from r2d2dpg_torch.agents.ddpg import UNROLL_METRIC
    from r2d2dpg_torch.agents.graph import GRAPH_METRIC
    from r2d2dpg_torch.kernels import LSTM_SEQ
    from r2d2dpg_torch.obs import get_registry

    def cells(name):
        inst = get_registry().get(name)
        return [] if inst is None else [(k, c.value) for k, c in inst._cells_snapshot()]

    unrolls = sum(v for k, v in cells(UNROLL_METRIC) if k == ("sequence", "float32"))
    bodies = sum(v * (2 if event == "capture" else 1)
                 for (event, reason), v in cells(GRAPH_METRIC)
                 if event == "capture" or (event == "eager" and reason != "cpu"))
    return LSTM_SEQ.launches, unrolls, bodies


def _lstm_since(mark):
    """``_lstm_mark()`` less ``mark``."""
    return tuple(b - a for a, b in zip(mark, _lstm_mark()))


def _lstm_check(label, launched, unrolls, bodies, float32_lstm) -> int:
    """Record a main path's LSTM_SEQ launches under ``label`` and hold them
    to the counters over the same steps: a float32 LSTM path launches the
    kernel once forward a sequence unroll and three times backward a
    learner-step body (the critic loss's critic, the actor loss's actor
    and critic), and at least once; a bf16 path never.  A miss is kept for
    the end of the run.  Returns ``launched``."""
    want = unrolls + 3 * bodies if float32_lstm else 0
    LSTM_LAUNCHES[label] = launched
    if launched != want or (float32_lstm and not launched):
        LSTM_MISSES.append(f"{label}: {launched} lstm_seq launches, expected {want:g} "
                           f"({unrolls:g} float32 sequence unrolls, {bodies:g} "
                           "learner-step bodies)")
    return launched


def _learner_leg(torch, dev, label, config, steps=45, warmup=5, fill=None,
                 capacity=None, chunk=2048):
    """sample -> learner_step -> update_priorities at ``config``'s published shapes.

    Synthetic sequences fill ``fill`` slots (all of them by default) of an
    arena of the config's capacity; the batch, sequence length, widths and
    knobs are the config's.  The scatter's launch count is set to 0 just
    before the timed loop and must equal its steps just after; the LSTM
    kernel's is held to the counters over the same steps (``_lstm_check``).
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
    lstm0 = _lstm_mark()
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
    lstm = _lstm_check(label, *_lstm_since(lstm0), _float32_lstm(config))
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
        "lstm_seq_launches": lstm,
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


# What the collectives of a world of one leave on the card's timeline:
# NCCL's own kernels, and the device-to-device copies NCCL makes for an
# out-of-place collective over one rank.
COLLECTIVE_EVENTS = {
    "nccl_kernels": lambda name: "nccl" in name or "onerank" in name,
    "memcpy_dtod": lambda name: name.startswith("memcpy dtod"),
}


@contextlib.contextmanager
def _group_of_one():
    """Around a mesh leg: the process group of one it brings up is torn
    down after it, so every other leg runs in a process without one."""
    from r2d2dpg_torch.parallel import distributed

    try:
        yield
    finally:
        distributed.shutdown()


def _learner_dp1_leg(torch, dev, steps=45, warmup=5, fill=4096, chunk=2048):
    """``DPLearnerTrainer`` at walker_r2d2's published shapes on a world of
    one over NCCL, beside the plain ``Trainer`` on an identical arena.

    Both trainers' arenas get the same synthetic sequences and priorities
    (``fill`` resident of capacity 100k), both learners the same init and
    the same draws (``Draws(0)``); ``steps`` learner steps each through
    ``Trainer._learn_step`` (sample, IS weights, learner step, write-back).
    Then the params and the priorities must be bitwise equal, and the
    scatter's launches must equal the dp learner's steps (counted over the dp learner's own steps: after a
    warm-up of ``warmup`` steps each, the timed steps run in blocks that
    take turns, plain, dp, dp, plain, so both see the same host).  Two
    more steps of each are traced for device time, NCCL kernels and
    device-to-device copies."""
    import types

    from r2d2dpg_torch.envs.core import EnvSpec
    from r2d2dpg_torch.kernels import PRIORITY_SCATTER
    from r2d2dpg_torch.parallel import DPLearnerTrainer, make_mesh
    from r2d2dpg_torch.replay import SequenceBatch
    from r2d2dpg_torch.training.draws import Draws
    from r2d2dpg_torch.training.trainer import Trainer
    from r2d2dpg_torch.tree import tree_leaves

    config = _config("walker_r2d2")
    obs_shape, _, act_dim = ENV_SHAPES[config.name]
    env = types.SimpleNamespace(spec=EnvSpec(config.name, obs_shape, act_dim))
    t_setup = time.perf_counter()
    mesh = make_mesh(1, dev)
    trainers = {"plain": Trainer(env, config.build_agent(env), config.trainer, dev),
                "dp": DPLearnerTrainer(env, config.build_agent(env), config.trainer, mesh)}
    agent = trainers["plain"].agent
    seq_len, batch = agent.config.seq_len, config.trainer.batch_size
    g = torch.Generator(device=dev).manual_seed(0)
    states = {}
    for start in range(0, fill, chunk):
        n = min(chunk, fill - start)
        seqs = SequenceBatch(
            obs=torch.randn(n, seq_len, *obs_shape, generator=g, device=dev),
            action=torch.rand(n, seq_len, act_dim, generator=g, device=dev) * 2 - 1,
            reward=torch.randn(n, seq_len, generator=g, device=dev),
            discount=torch.ones(n, seq_len, device=dev),
            reset=torch.zeros(n, seq_len, device=dev),
            carries={"actor": agent.actor.initial_carry(n, dev),
                     "critic": agent.critic.initial_carry(n, dev)},
        )
        prios = torch.rand(n, generator=g, device=dev) + 0.5
        for name, t in trainers.items():
            if name not in states:
                states[name] = t.arena.init_state(seqs)
            t.arena.add(states[name], seqs, prios)
    runs = {name: {"train": t.agent.init(torch.Generator().manual_seed(0), dev),
                   "arena": states[name], "draws": Draws(0, dev)}
            for name, t in trainers.items()}
    torch.cuda.synchronize()
    setup_seconds = time.perf_counter() - t_setup

    def stepper(name):
        t, r = trainers[name], runs[name]

        def one_step():
            r["train"], r["arena"], r["metrics"] = t._learn_step(
                r["train"], r["arena"], r["draws"])
        return one_step

    # Warm-up, then the timed steps in blocks taking turns (plain, dp, dp,
    # plain, ...), so both see the same host.  The dp learner's launches
    # are counted over its own blocks only.
    blocks = 4  # each learner's timed steps, in (plain, dp, dp, plain) turns
    if (steps - warmup) % blocks:
        raise ValueError(f"learner_dp1: {steps - warmup} timed steps in {blocks} blocks")
    per_block = (steps - warmup) // blocks
    order = ["plain"] * warmup + ["dp"] * warmup
    order += [name for _ in range(blocks // 2) for name in ("plain", "dp", "dp", "plain")
              for _ in range(per_block)]
    seconds, launches = {"plain": 0.0, "dp": 0.0}, 0
    lstm = (0, 0, 0)  # _lstm_since over the dp learner's blocks
    steppers = {name: stepper(name) for name in trainers}
    torch.cuda.synchronize()
    k = 0
    while k < len(order):
        name = order[k]
        n = warmup if k < 2 * warmup else per_block
        before, lstm0 = PRIORITY_SCATTER.launches, _lstm_mark()
        t0 = time.perf_counter()
        for _ in range(n):
            steppers[name]()
        torch.cuda.synchronize()
        if k >= 2 * warmup:
            seconds[name] += time.perf_counter() - t0
        if name == "dp":
            launches += PRIORITY_SCATTER.launches - before
            lstm = tuple(a + b for a, b in zip(lstm, _lstm_since(lstm0)))
        k += n
    rec = {}
    for name in ("plain", "dp"):
        metrics = runs[name]["metrics"]
        if not bool(torch.isfinite(torch.stack(list(metrics.values()))).all()):
            raise AssertionError(f"learner_dp1: non-finite {name} metrics")
        rec[name] = {"steps_per_s": (steps - warmup) / seconds[name],
                     "wall_ms_per_step": seconds[name] / (steps - warmup) * 1e3}
    pairs = list(zip(tree_leaves(runs["plain"]["train"]), tree_leaves(runs["dp"]["train"]),
                     strict=True))
    params_bitwise = all(torch.equal(a, b) for a, b in pairs)
    prio_bitwise = torch.equal(runs["plain"]["arena"].priority, runs["dp"]["arena"].priority)
    for name in ("plain", "dp"):
        device_ms, top, events, coll = _device_profile(stepper(name), 2, COLLECTIVE_EVENTS)
        wall = rec[name]["wall_ms_per_step"]
        rec[name].update(
            device_busy_ms_per_step=device_ms, device_events_per_step=events,
            device_idle_share=None if device_ms is None else 1 - device_ms / wall,
            collectives_per_step=coll, top_device_ms_per_step=top)
    out = {"config": "walker_r2d2", "batch": batch, "seq_len": seq_len,
           "hidden": config.hidden, "capacity": config.trainer.capacity,
           "resident": fill, "world_size": mesh.size,
           "backend": torch.distributed.get_backend(),
           "steps": steps, "timed_steps": steps - warmup,
           "setup_seconds": setup_seconds, "scatter_launches": launches,
           "lstm_seq_launches": _lstm_check("learner_dp1", *lstm, _float32_lstm(config)),
           "params_bitwise": params_bitwise, "priorities_bitwise": prio_bitwise,
           **rec}
    print(json.dumps({"learner_dp1": out}), flush=True)
    if launches != steps:
        raise AssertionError(f"learner_dp1: {launches} scatter launches for {steps} steps")
    if not (params_bitwise and prio_bitwise):
        raise AssertionError(f"learner_dp1: not bitwise the plain trainer: {out}")
    if not rec["dp"]["collectives_per_step"]["nccl_kernels"]["count_per_call"]:
        raise AssertionError("learner_dp1: no NCCL kernel on the card's timeline")
    return {"learner_dp1": launches}


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
    # its new optimizer states are the first step's raw gradients (the
    # eager body: a graphed step would need Adam's states back).
    capture = R2D2DPG(agent.actor, agent.critic, cfg)
    capture._optimize = lambda params, g, opt_state, lr: (params, g)
    out, grads, seconds = {}, {}, {}
    for d in ("cpu", dev):
        t0 = time.perf_counter()
        train = agent.init(torch.Generator().manual_seed(0), d)
        b = tree_map(lambda x: x.to(d), batch)
        first = None if normals[0] is None else normals[0].to(d)
        g = capture._learner_step_eager(train, b, w.to(d), first)[0]
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
        lstm0 = _lstm_mark()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            state = train_main([
                "--config", "pendulum_r2d2", "--phases", str(train_phases),
                "--log-every", "16", *flags,
            ])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels.ALL_KERNELS}
        _lstm_check(label, *_lstm_since(lstm0), _float32_lstm(config))
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


# The topology stamp each mesh leg must print (the JAX package's
# ``Topology.describe()`` for the same flags; tests/test_torch_topology.py
# holds these strings to it).
TOPOLOGY_STAMPS = {
    ("--spmd", "1"): (
        "collect=local ingest=fused sample=arena learn=spmd_mesh "
        "schedule=phase_locked actors=0 replay_shards=0 shard_procs=0 "
        "shard_direct=0 learner_dp=0 spmd=1"),
    ("--learner-dp", "1"): (
        "collect=local ingest=fused sample=arena learn=dp_mesh "
        "schedule=phase_locked actors=0 replay_shards=0 shard_procs=0 "
        "shard_direct=0 learner_dp=1 spmd=0"),
    ("--actors", "2", "--learner-dp", "1"): (
        "collect=fleet ingest=central_drain sample=arena learn=dp_mesh "
        "schedule=drain_paced actors=2 replay_shards=0 shard_procs=0 "
        "shard_direct=0 learner_dp=1 spmd=0"),
    ("--actors", "2", "--replay-shards", "2", "--learner-dp", "1"): (
        "collect=fleet ingest=sharded_rings sample=two_level learn=dp_mesh "
        "schedule=free_running actors=2 replay_shards=2 shard_procs=0 "
        "shard_direct=0 learner_dp=1 spmd=0"),
}


def _stamp_checked(label, flags, lines, logdir):
    """The run printed ``topology: <stamp>`` and wrote it to topology.txt."""
    want = TOPOLOGY_STAMPS[tuple(flags)]
    with open(os.path.join(logdir, "topology.txt")) as f:
        written = f.read()
    if f"topology: {want}" not in lines or written != want + "\n":
        raise AssertionError(f"{label}: topology stamp {lines[:3]} / {written!r}")
    return want


def _mesh_cli_legs(torch, dev, plain):
    """``train.main --config pendulum_r2d2 --phases 10 --log-every 16`` with
    ``--spmd 1``, then ``--learner-dp 1``: a process group of one over NCCL.
    Each prints the topology stamp and writes topology.txt, launches the
    scatter once per learner step (counts set to 0 just before and read
    just after), and ends bitwise on ``plain``, the plain trainer run's
    final params and priorities at the same seed.  The dp run's
    ``r2d2dpg_dp_shard_occupancy{shard="0"}`` reads the arena's size."""
    from r2d2dpg_torch import kernels
    from r2d2dpg_torch.obs import get_registry
    from r2d2dpg_torch.train import main as train_main
    from r2d2dpg_torch.tree import tree_leaves

    config = _config("pendulum_r2d2")
    train_phases = 10
    out = {}
    for label, flags in (("spmd1", ("--spmd", "1")),
                         ("learner_dp1_cli", ("--learner-dp", "1"))):
        logdir = tempfile.mkdtemp(prefix=f"chip_smoke_{label}_")
        buf = io.StringIO()
        try:
            for k in kernels.ALL_KERNELS:
                k.launches = 0
            lstm0 = _lstm_mark()
            t0 = time.perf_counter()
            with _group_of_one(), contextlib.redirect_stdout(buf):
                state = train_main([
                    "--config", "pendulum_r2d2", "--phases", str(train_phases),
                    "--log-every", "16", "--logdir", logdir, *flags,
                ])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {k.name: k.launches for k in kernels.ALL_KERNELS}
            _lstm_check(label, *_lstm_since(lstm0), _float32_lstm(config))
            lines = buf.getvalue().splitlines()
            stamp = _stamp_checked(label, flags, lines, logdir)
        finally:
            shutil.rmtree(logdir, ignore_errors=True)
        expected = train_phases * config.trainer.learner_steps
        pairs = list(zip(tree_leaves(plain["train"]), tree_leaves(state.train), strict=True))
        rec = {"flags": list(flags), "train_phases": train_phases, "run_seconds": seconds,
               "topology": stamp, "scatter_launches": launches["priority_scatter"],
               "params_bitwise": all(torch.equal(a, b) for a, b in pairs),
               "priorities_bitwise": torch.equal(plain["priority"], state.arena.priority),
               "last_log_line": [x for x in lines if x.startswith("phase ")][-1]}
        if label == "learner_dp1_cli":
            gauge = get_registry().get("r2d2dpg_dp_shard_occupancy")
            rec["shard_occupancy"] = gauge.labels(shard="0").value
            rec["arena_size"] = min(state.arena.total_added, config.trainer.capacity)
        print(json.dumps({label: rec}), flush=True)
        if launches["priority_scatter"] != expected:
            raise AssertionError(f"{label}: scatter launches {launches}, expected {expected}")
        if not (rec["params_bitwise"] and rec["priorities_bitwise"]):
            raise AssertionError(f"{label}: not bitwise the plain run: {rec}")
        if label == "learner_dp1_cli" and rec["shard_occupancy"] != rec["arena_size"]:
            raise AssertionError(f"{label}: shard occupancy {rec}")
        out[label] = launches["priority_scatter"]
    return out


TELEMETRY_TRAIN_PHASES = 12
TELEMETRY_WINDOW = (4, 3)  # --profile-window P:N, train phases P..P+N-1
# Dense fp32 peak of an H100 SXM (PERF.md section 3): the MFU denominator
# of the telemetry run.
H100_FP32_PEAK_FLOPS = 6.7e13
SCRAPE_EVERY_S = 0.25
_METRIC_LINE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{.*\})? \S+$")


class _Scraper:
    """A thread that GETs ``paths`` of a run's exporter every ``every`` s,
    once ``<logdir>/obs_port.txt`` names its port; ``samples`` holds
    ``(t_wall, path, status, ms, body)``."""

    def __init__(self, logdir, paths, every):
        import threading

        self.logdir, self.paths, self.every = logdir, paths, every
        self.samples = []
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, name="chip-smoke-scraper",
                                        daemon=True)

    def port(self):
        try:
            with open(os.path.join(self.logdir, "obs_port.txt")) as f:
                return int(f.read())
        except (OSError, ValueError):
            return None

    def get(self, path):
        import urllib.error
        import urllib.request

        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{self.port()}{path}", timeout=10) as r:
                status, body = r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            status, body = e.code, ""
        sample = (time.time(), path, status, (time.perf_counter() - t0) * 1e3, body)
        self.samples.append(sample)
        return sample

    def _run(self):
        while not self._done.wait(self.every):
            if self.port() is None:
                continue
            for path in self.paths:
                self.get(path)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._done.set()
        self._thread.join()
        return False


def _metric(text, name):
    """The value of the unlabelled series ``name`` in a /metrics page."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    return None


def _series(text, name):
    """Every sample of ``name`` in a /metrics page, as (labels, value)."""
    out = []
    for line in text.splitlines():
        head, _, value = line.rpartition(" ")
        if head == name:
            labels = {}
        elif head.startswith(name + "{") and head.endswith("}"):
            labels = dict(re.findall(r'(\w+)="([^"]*)"', head[len(name) + 1:-1]))
        else:
            continue
        out.append((labels, float(value)))
    return out


def _fresh_telem_plane():
    """Before a TELEM leg: no fold of an earlier leg.  The registry and the
    remote mirror are process-wide, and every HELLO of an earlier leg armed
    a staleness clock that keeps growing after its run (it would read as
    ``telem_stale`` here)."""
    from r2d2dpg_torch.obs import get_registry, get_remote_mirror

    get_remote_mirror().clear()
    for name in ("r2d2dpg_fleet_telem_staleness_seconds",
                 "r2d2dpg_shard_telem_staleness_seconds"):
        inst = get_registry().get(name)
        if inst is not None:
            with inst._lock:
                inst._cells.clear()


def _telemetry_phase(torch, dev):
    """The train CLI with telemetry on, at pendulum_r2d2's full width:
    ``--obs-port 0 --profile-window 4:3 --device-peak-flops`` (the H100
    SXM's dense fp32 peak), its exporter scraped every 0.25 s, then the
    flight ``merge`` CLI on its run directory."""
    from r2d2dpg_torch import kernels
    from r2d2dpg_torch.obs import get_device_monitor, get_flight_recorder, get_registry
    from r2d2dpg_torch.train import main as train_main

    tc = _config("pendulum_r2d2").trainer
    p0, n = TELEMETRY_WINDOW
    logdir = tempfile.mkdtemp(prefix="chip_smoke_telemetry_")
    flops = get_registry().get("r2d2dpg_device_learn_flops_total")
    flops_before = flops.value if flops is not None else 0.0
    seq0 = get_flight_recorder().recorded_total
    buf = io.StringIO()
    try:
        for k in kernels.ALL_KERNELS:
            k.launches = 0
        lstm0 = _lstm_mark()
        t0 = time.perf_counter()
        with _Scraper(logdir, ("/metrics", "/metrics.json", "/health", "/healthz"),
                      SCRAPE_EVERY_S) as scraper, contextlib.redirect_stdout(buf):
            state = train_main([
                "--config", "pendulum_r2d2", "--phases", str(TELEMETRY_TRAIN_PHASES),
                "--log-every", "1", "--logdir", logdir, "--obs-port", "0",
                "--obs-host", "127.0.0.1", "--profile-window", f"{p0}:{n}",
                "--device-peak-flops", str(H100_FP32_PEAK_FLOPS),
            ])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {k.name: k.launches for k in kernels.ALL_KERNELS}
            _lstm_check("telemetry", *_lstm_since(lstm0), True)  # pendulum_r2d2
            final_metrics = scraper.get("/metrics")
            final_health = scraper.get("/health")
        get_flight_recorder().dump(os.path.join(logdir, "flight.jsonl"))
        per_phase = get_device_monitor()._learn_flops_per_dispatch
        flops_run = get_registry().get("r2d2dpg_device_learn_flops_total").value - flops_before
        # The profile window's trace: the scatter's kernels inside it.
        (trace_name,) = os.listdir(os.path.join(logdir, "profile_window"))
        with open(os.path.join(logdir, "profile_window", trace_name)) as f:
            trace = json.load(f)["traceEvents"]
        window_scatters = [e for e in trace if e.get("cat") == "kernel"
                           and "scatter_last_wins" in e.get("name", "")]
        merge = subprocess.run(
            [sys.executable, "-m", "r2d2dpg_torch.obs.flight", "merge", logdir,
             "-o", os.path.join(logdir, "merged.jsonl"),
             "--trace-out", os.path.join(logdir, "fused.json")],
            cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
            text=True, timeout=300)
        fused = []
        if merge.returncode == 0:
            with open(os.path.join(logdir, "fused.json")) as f:
                fused = [e for e in json.load(f)["traceEvents"]
                         if e["name"] == "profile_window"]
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    events = [e for e in get_flight_recorder().events()
              if e["seq"] >= seq0 and e["kind"] in ("profile_start", "profile_stop",
                                                    "profile_failed")]
    samples = scraper.samples
    metrics_pages = [s for s in samples if s[1] == "/metrics"]
    health = [json.loads(s[4])["verdict"] for s in samples if s[1] == "/health"
              and s[2] == 200]
    mfus = [_metric(s[4], "r2d2dpg_device_mfu") for s in metrics_pages]
    bad_lines = [line for s in metrics_pages for line in s[4].splitlines()
                 if line and not line.startswith("#") and not _METRIC_LINE.match(line)]
    latency = {}
    for path in ("/metrics", "/metrics.json", "/health", "/healthz"):
        ms = sorted(s[3] for s in samples if s[1] == path)
        latency[path] = {"n": len(ms), "p50_ms": statistics.median(ms) if ms else None,
                         "p99_ms": ms[min(len(ms) - 1, int(0.99 * len(ms)))] if ms else None}
    final_mfu = _metric(final_metrics[4], "r2d2dpg_device_mfu")
    window_us = [e["dur"] for e in window_scatters]
    rec = {
        "train_phases": TELEMETRY_TRAIN_PHASES, "run_seconds": seconds,
        "learn_flops_per_phase": per_phase, "learn_flops_run": flops_run,
        "peak_flops": H100_FP32_PEAK_FLOPS, "mfu_final": final_mfu,
        "mfu_max": max((m for m in mfus if m is not None), default=None),
        "scrapes": len(samples), "scrape_latency": latency,
        "health_verdicts": sorted(set(health)), "final_health": json.loads(final_health[4]),
        "scatter_launches": launches["priority_scatter"],
        "window_scatter_kernels": len(window_scatters),
        "window_scatter_mean_cupti_us": statistics.mean(window_us) if window_us else None,
        "profile_events": [(e["kind"], e.get("phase")) for e in events],
        "trace_events_in_window": len(trace), "merge_rc": merge.returncode,
        "merge_stderr": merge.stderr.strip().splitlines()[-2:],
        "fused_profile_windows": len(fused),
    }
    print("last log line:", [x for x in buf.getvalue().splitlines()
                             if x.startswith("phase ")][-1], flush=True)
    print(json.dumps({"telemetry": rec}), flush=True)
    k = tc.learner_steps
    problems = []
    if any(s[2] != 200 for s in samples) or not metrics_pages or not health:
        problems.append("a scrape failed or none ran")
    if bad_lines:
        problems.append(f"malformed /metrics lines {bad_lines[:3]}")
    if set(health) != {"ok"} or rec["final_health"]["verdict"] != "ok":
        problems.append("/health not ok")
    if not (final_mfu is not None and 0.0 < final_mfu <= 1.05) or any(
            m is not None and not 0.0 <= m <= 1.05 for m in mfus):
        problems.append("MFU outside (0, 1.05]")
    if 'r2d2dpg_device_hbm_bytes_in_use{device="0"}' not in final_metrics[4]:
        problems.append("no r2d2dpg_device_hbm_bytes_in_use{device=\"0\"}")
    # The port counts every train phase (its cost is known once the first
    # phase, run under the counter, ends); JAX's lazy cost adds 0 for the
    # phases before the first publish evaluates it.
    if not per_phase > 0 or flops_run != per_phase * TELEMETRY_TRAIN_PHASES:
        problems.append("learn FLOPs counter != FLOPs per phase x train phases")
    if launches["priority_scatter"] != TELEMETRY_TRAIN_PHASES * k:
        problems.append("scatter launches != train phases x learner_steps")
    if len(window_scatters) != n * k:
        problems.append("scatter kernels in the window != window phases x learner_steps")
    if rec["profile_events"] != [("profile_start", p0), ("profile_stop", p0 + n)]:
        problems.append("profile_start/profile_stop flight events")
    if merge.returncode != 0 or len(fused) != 1:
        problems.append("flight merge did not fuse one profile_window span")
    if problems:
        raise AssertionError(f"telemetry: {problems}: {rec}")
    return {"telemetry": launches["priority_scatter"]}, rec


def _flop_parity(torch, dev):
    """``flops_of`` of one learner step at pendulum_tiny width on the card
    and on the CPU: the same ops, so exactly the same count (the backward
    runs on autograd's CUDA thread on the card)."""
    from r2d2dpg_torch.obs.device import flops_of

    counts = {}
    for d in ("cpu", dev):
        trainer = _config("pendulum_tiny").build(d)
        state = trainer.init()
        warm, fill = trainer.window_fill_phases, trainer.replay_fill_phases
        for phase in range(warm + fill):
            state = (trainer.collect_phase(state) if phase < warm
                     else trainer.fill_phase(state))
        counts[str(d)] = flops_of(trainer._learn_step, state.train, state.arena,
                                  state.draws)
    print(json.dumps({"flop_parity": counts}), flush=True)
    if not counts["cpu"] or counts["cpu"] != counts[str(dev)]:
        raise AssertionError(f"flops_of card vs CPU: {counts}")


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

    from r2d2dpg_torch import train as train_mod

    label = "pendulum_r2d2_pipelined"
    config = _config("pendulum_r2d2")
    tc = config.trainer
    logdir = tempfile.mkdtemp(prefix="chip_smoke_pipeline_")
    buf = io.StringIO()
    made = []  # the executor train.main builds, for its param versions

    class Recording(PipelineExecutor):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    train_mod.PipelineExecutor = Recording
    try:
        random.seed(0)  # which batches --trace-sample picks
        get_flight_recorder().clear_spans()
        with _entry_priorities(torch, dev, tc.capacity) as entered:
            for k in kernels.ALL_KERNELS:
                k.launches = 0
            lstm0 = _lstm_mark()
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
            _lstm_check(label, *_lstm_since(lstm0), _float32_lstm(config))
        trace_written = os.path.exists(os.path.join(logdir, "trace.json"))
    finally:
        train_mod.PipelineExecutor = PipelineExecutor
        shutil.rmtree(logdir, ignore_errors=True)
    _check_versions(label, made[0], train_phases, 2)
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
        lstm0 = _lstm_mark()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            resumed = train_main(["--config", "pendulum_r2d2", "--phases", "5",
                                  "--log-every", "16", "--checkpoint-dir", ckdir,
                                  "--checkpoint-every", "5", "--resume"])
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        resume_launches = kernels.PRIORITY_SCATTER.launches
        _lstm_check("pendulum_r2d2_resume", *_lstm_since(lstm0), True)
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


# Drain-learn phases per fleet leg: the run must outlast the killed actor's
# restart (the supervisor's poll, 0.5 s of backoff, the spawn), which 60
# did only just once the learner step replayed as a CUDA graph (60 phases
# in 2.0 s on an H100 host).
FLEET_TRAIN_PHASES = 240
FLEET_ACTORS = 3
FLEET_KILL_AT = 20  # learner steps before one actor is killed
FLEET_CARD_VS_CPU_ATOL = 1e-4  # params, as the card-vs-CPU learner check


def _proc_stat(pid):
    """(cpu seconds, threads) of a live process from /proc, or None."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
    except OSError:
        return None
    ticks = os.sysconf("SC_CLK_TCK")
    # After the ")": state is field 3; utime 14, stime 15, num_threads 20.
    return (int(fields[11]) + int(fields[12])) / ticks, int(fields[17])


def _card_fds(pid):
    """The /dev/nvidia* files a process holds open (a CUDA context opens
    the card's device file)."""
    out = set()
    try:
        for fd in os.listdir(f"/proc/{pid}/fd"):
            try:
                target = os.readlink(f"/proc/{pid}/fd/{fd}")
            except OSError:
                continue
            if target.startswith("/dev/nvidia"):
                out.add(target)
    except OSError:
        pass
    return sorted(out)


def _compute_apps():
    """nvidia-smi's compute processes on the card, one line each."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,process_name,used_memory",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return [x.strip() for x in out.splitlines() if x.strip()]


def _fleet_leg(torch, dev, label, flags):
    """``train.main --actors 3`` at pendulum_r2d2: the learner on the card,
    3 supervised actor subprocesses on the CPU; one actor killed after
    ``FLEET_KILL_AT`` learner steps, exactly one restart required.  Launch
    counts are set to 0 just before and read just after."""
    import threading

    from r2d2dpg_torch import kernels
    from r2d2dpg_torch.fleet.supervisor import ActorSupervisor
    from r2d2dpg_torch.train import main as train_main

    tc = _config("pendulum_r2d2").trainer
    logdir = tempfile.mkdtemp(prefix=f"chip_smoke_{label}_")
    seen = {}
    done = threading.Event()
    plain_start = ActorSupervisor.start

    def start(self):
        seen["sup"] = self
        return plain_start(self)

    def watch():
        """Samples the actors' CPU use; kills one actor part-way."""
        usage, killed = {}, None
        while not done.wait(0.25):
            sup = seen.get("sup")
            if sup is None:
                continue
            for i, pid in sup.pids().items():
                st = _proc_stat(pid)
                if st is not None:
                    usage[(i, pid)] = st
            if killed is None and kernels.PRIORITY_SCATTER.launches >= FLEET_KILL_AT:
                apps = _compute_apps()
                fds = {i: _card_fds(pid) for i, pid in sup.pids().items()}
                killed = {"actor": 1, "at_learner_steps": kernels.PRIORITY_SCATTER.launches,
                          "t_kill": time.time(), "delivered": sup.kill_actor(1),
                          "compute_apps": apps, "actor_card_fds": fds}
        seen["usage"], seen["killed"] = usage, killed

    ActorSupervisor.start = start
    watcher = threading.Thread(target=watch, name="chip-smoke-fleet-watch", daemon=True)
    buf = io.StringIO()
    # The f32 leg serves /health, polled every 0.2 s (recorded, not held).
    health = not flags
    obs_flags = ("--obs-port", "0", "--obs-host", "127.0.0.1") if health else ()
    scraper = _Scraper(logdir, ("/health",) if health else (), 0.2)
    try:
        for k in kernels.ALL_KERNELS:
            k.launches = 0
        lstm0 = _lstm_mark()
        watcher.start()
        t0, cpu0, t0_wall = time.perf_counter(), sum(os.times()[:2]), time.time()
        with scraper, contextlib.redirect_stdout(buf):
            state = train_main([
                "--config", "pendulum_r2d2", "--actors", str(FLEET_ACTORS),
                "--phases", str(FLEET_TRAIN_PHASES),
                "--log-every", str(max(FLEET_TRAIN_PHASES // 3, 1)),
                "--logdir", logdir, *obs_flags, *flags,
            ])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        learner_cpu_s = sum(os.times()[:2]) - cpu0
        launches = {k.name: k.launches for k in kernels.ALL_KERNELS}
        _lstm_check(label, *_lstm_since(lstm0), True)  # pendulum_r2d2's learner
        _stall_report(label, _merged_events(logdir, t0_wall), t0_wall)
    finally:
        done.set()
        watcher.join()
        ActorSupervisor.start = plain_start
        shutil.rmtree(logdir, ignore_errors=True)
    lines = buf.getvalue().splitlines()
    stats_line = next(x for x in lines if x.startswith("fleet: ") and "wall_s" in x)
    words = stats_line.split()[1:]
    stats = {k: float(v) for k, v in zip(words[::2], words[1::2])}
    killed = seen.get("killed")
    expected = FLEET_TRAIN_PHASES * tc.learner_steps
    if killed is None or not killed["delivered"]:
        raise AssertionError(f"{label}: no actor was killed ({killed})")
    if stats["actor_restarts"] != 1:
        raise AssertionError(f"{label}: {stats['actor_restarts']} restarts, expected 1")
    if stats["train_phases"] != FLEET_TRAIN_PHASES or state.train.step != expected:
        raise AssertionError(f"{label}: {stats['train_phases']} phases, step "
                             f"{state.train.step}; expected {FLEET_TRAIN_PHASES}")
    if launches["priority_scatter"] != expected:
        raise AssertionError(f"{label}: scatter launches {launches}, expected {expected}")
    last = [x for x in lines if x.startswith("phase ")][-1]
    numbers = []
    for word in last.split()[3:]:
        try:
            numbers.append(float(word.strip("()")))
        except ValueError:
            continue
    if not all(math.isfinite(x) for x in numbers):
        raise AssertionError(f"{label}: non-finite metrics: {last}")
    if not bool(torch.isfinite(state.arena.priority).all()):
        raise AssertionError(f"{label}: non-finite arena priorities")
    usage = seen["usage"]
    print("fleet stats line:", stats_line, flush=True)
    print("last log line:", last, flush=True)
    print(json.dumps({label: {
        "flags": list(flags), "actors": FLEET_ACTORS,
        "train_phases": FLEET_TRAIN_PHASES, "run_seconds": seconds,
        "drain_phases_per_s": stats.get("train_drain_phases_per_sec"),
        "arena_add_seqs_per_s": stats.get("train_arena_add_seqs_per_sec"),
        "learner_steps_per_s": stats.get("train_learner_steps_per_sec"),
        "learner_wait_ms": [stats["learner_wait_p50_ms"], stats["learner_wait_p99_ms"]],
        "absorb_wait_ms": [stats["absorb_wait_p50_ms"], stats["absorb_wait_p99_ms"]],
        "drain_learn_ms": [stats["drain_learn_p50_ms"], stats["drain_learn_p99_ms"]],
        "sheds": stats["sheds"], "bytes_per_seq": stats["bytes_per_seq"],
        "wire_ratio": stats["wire_ratio"], "restarts": stats["actor_restarts"],
        "first_seqs_s": {k: v for k, v in stats.items() if k.endswith("_first_seqs_s")},
        "killed": killed, "compute_apps_on_card": len(killed["compute_apps"]),
        "host_cores": os.cpu_count(),
        "actor_cpu": [{"actor": i, "pid": pid, "cpu_s": cpu, "threads": th}
                      for (i, pid), (cpu, th) in sorted(usage.items())],
        "learner_cpu_s": learner_cpu_s,
        "stats": stats, "scatter_launches": launches["priority_scatter"],
        "actors_down_seen": _actors_down_seen(scraper.samples, killed),
    }}), flush=True)
    # One compute process on the card (the learner); no actor holds a card
    # device file open.
    if len(killed["compute_apps"]) != 1 or any(killed["actor_card_fds"].values()):
        raise AssertionError(f"{label}: card processes {killed}")
    return {label: launches["priority_scatter"]}


def _stall_report(label, events, t0_wall):
    """Print where each long drain-learn iteration's time went (the
    ``drain_stall`` events of ``fleet/ingest.py::_StallClock``) beside the
    sheds' times: recorded, not held."""
    keys = ("drained", "wall_s", "segments_ms", "thread_cpu_ms", "process_cpu_ms",
            "threads", "queued", "stack")
    stalls = [{"t_s": round(e["t_wall"] - t0_wall, 3), **{k: e.get(k) for k in keys}}
              for e in events if e["kind"] == "drain_stall"]
    waits = [(round(e["t_wall"] - t0_wall, 3), round(e["wait_s"], 3), e.get("shed"),
              e.get("actor")) for e in events if e["kind"] == "put_wait"]
    clock = [{k: e.get(k) for k in ("iterations", "wall_s", "thread_cpu_s", "cpu_share")}
             for e in events if e["kind"] == "drain_clock"]
    print(json.dumps({f"{label}_drain_stalls": {
        "count": len(stalls), "stalls": stalls[:30],
        "drain_clock": clock, "put_waits_over_0.5s": len(waits),
        "put_waits": waits[:40],
        "shed_t_s": [round(e["t_wall"] - t0_wall, 3) for e in events
                     if e["kind"] == "shed"]}}), flush=True)
    return stalls


def _actors_down_seen(samples, killed):
    """/health polls in the 10 s after the actor kill (its restart's
    backoff is 0.5 s) that named actors_down, as (seconds after the kill,
    value, threshold); None when nothing polled."""
    polls = [(t, json.loads(body)) for t, _, status, _, body in samples
             if status == 200]
    if not polls or killed is None:
        return None
    t_kill = killed["t_kill"]
    return [(round(t - t_kill, 3), f["value"], f["threshold"]) for t, b in polls
            if t_kill <= t <= t_kill + 10.0 for f in b["findings"]
            if f["rule"] == "actors_down"]


class _HostDraws:
    """A ``Draws`` that draws on a CPU generator and moves the numbers to
    the learner's device, so a card run and a CPU run see the same draws."""

    def __init__(self, seed, device):
        import torch

        self.device = torch.device(device)
        self.generator = torch.Generator().manual_seed(seed)

    def normal(self, shape):
        import torch

        return torch.randn(tuple(shape), generator=self.generator).to(self.device)

    def uniform(self, shape, low=0.0, high=1.0):
        import torch

        u = torch.rand(tuple(shape), generator=self.generator)
        return (u * (high - low) + low).to(self.device)


def _fleet_card_vs_cpu(torch, dev, learn_phases=5, min_replay=32):
    """FleetLearner's drain on the card against itself on the CPU, fed the
    same recorded batches: pendulum_r2d2 width, the batches recorded from
    the port's actor in a thread on the CPU (seed 0) and sent through the
    f32 wire codec; ``min_replay`` cut to 32 (8 absorbed batches).  Then
    device-busy time of drain-learn phases on the card."""
    import dataclasses
    import threading

    from r2d2dpg_torch.fleet import FleetActor, FleetConfig, FleetLearner, put_staged, wire
    from r2d2dpg_torch.training import pipeline
    from r2d2dpg_torch.training.pipeline import LearnerState, drain_staged

    config = _config("pendulum_r2d2")
    config = dataclasses.replace(config, trainer=dataclasses.replace(
        config.trainer, min_replay=min_replay))
    n_batches = min_replay // config.trainer.num_envs + learn_phases
    recorded = []

    def record():
        actor = FleetActor(config, actor_id=0, num_actors=1, address="unused:0",
                           seed=0, device="cpu")
        packer, unpacker = wire.TreePacker(wire.WireConfig()), wire.TreeUnpacker()
        while len(recorded) < n_batches:
            staged = actor.host_batch()
            if staged is not None:
                frame = b"".join(packer.pack({"phase": actor._phase, "staged": staged}))
                recorded.append(unpacker.unpack(frame)["staged"])

    th = threading.Thread(target=record, name="chip-smoke-thread-actor")
    th.start()
    th.join()
    plain_draws = pipeline.learner_draws
    pipeline.learner_draws = lambda draws, phase: _HostDraws(7, draws.device)
    out, secs = {}, {}
    try:
        for d in ("cpu", dev):
            t0 = time.perf_counter()
            trainer = config.build(d)
            learner = FleetLearner(trainer, FleetConfig(
                num_actors=1, queue_depth=n_batches + 1))
            learner.start()
            try:
                for b in recorded:
                    learner.queue.put({"staged": b, "actor_id": "0"})
                state = learner.run(learn_phases, log_every=0)
            finally:
                learner.close()
            if d != "cpu":
                torch.cuda.synchronize()
            out[str(d)] = (trainer, state)
            secs[str(d)] = time.perf_counter() - t0
    finally:
        pipeline.learner_draws = plain_draws
    (_, sc), (tg, sg) = out["cpu"], out[str(dev)]
    errs = {}
    for part in ("actor_params", "critic_params", "target_actor_params",
                 "target_critic_params"):
        a, b = getattr(sc.train, part), getattr(sg.train, part)
        errs[part] = max((a[k] - b[k].cpu()).abs().max().item() for k in a)
    filled = sc.arena.priority > 0
    prio_err = (sc.arena.priority[filled] - sg.arena.priority.cpu()[filled]).abs().max().item()
    rec = {"batches": n_batches, "min_replay": min_replay, "learn_phases": learn_phases,
           "steps": [sc.train.step, sg.train.step], "max_param_err": errs,
           "max_priority_err": prio_err, "cpu_seconds": secs["cpu"],
           "card_seconds": secs[str(dev)], "atol": FLEET_CARD_VS_CPU_ATOL}
    ok = (sc.train.step == sg.train.step == learn_phases * config.trainer.learner_steps
          and max(errs.values()) <= FLEET_CARD_VS_CPU_ATOL and prio_err <= 1e-3)

    # Device-busy time of one drain-learn phase on the card (a recorded
    # batch ranked, added, one learner step), against its wall time.
    ls = LearnerState(train=sg.train, arena=sg.arena, draws=_HostDraws(8, dev))
    batches = [recorded[i % len(recorded)] for i in range(64)]
    k = [0]

    def one_drain():
        nonlocal ls
        staged = put_staged([batches[k[0] % len(batches)]], dev)
        k[0] += 1
        with tg.arena.staged_writer():
            ls, _ = drain_staged(tg, ls, staged, prefetch=True)

    for _ in range(3):
        one_drain()
    torch.cuda.synchronize()
    n = 20
    t1 = time.perf_counter()
    for _ in range(n):
        one_drain()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t1) / n * 1e3
    device_ms, top, events = _device_profile(one_drain, 3)
    rec.update(drain_phase_wall_ms=wall_ms, device_busy_ms_per_drain_phase=device_ms,
               device_events_per_drain_phase=events,
               device_idle_share=None if device_ms is None else 1 - device_ms / wall_ms,
               top_device_ms_per_drain_phase=top)
    print(json.dumps({"fleet_card_vs_cpu": rec}), flush=True)
    if not ok:
        raise AssertionError(f"fleet drain card vs CPU: {rec}")


# The central drain under the four actor-fleet faults.  The heartbeat
# must outlast the longest honest silence: a handler waiting for queue room
# through the first drain, which runs under the FLOP counter (the f32 leg's
# drain p99, 2.56 s on the card, PERF.md); a reap takes two silent
# deadlines, so the stall runs past twice the heartbeat.  Seed 3 gives the
# four faults disjoint targets (kill actor 2, corrupt actor 1, stall actor
# 0, conn-drop actor 1): a killed actor's restart re-arms its own drills.
# Drain-learn phases of the chaos leg: the run must outlast the stalled
# actor's reconnect (the 7 s stall, then ~0.6 s), which 40 phases did not
# always do once the actors ran one intra-op thread each and the learner
# drained faster, nor 80 once the learner step replayed as a CUDA graph
# (~12 drain phases a second).
FLEET_CHAOS_PHASES = 240
FLEET_CHAOS_HEARTBEAT_S = 2.5
FLEET_CHAOS_STALL_S = 7
FLEET_CHAOS_SEED = 3
FLEET_CHAOS_SPEC = (f"kill_actor@p5,corrupt_frame@p8,stall_actor@p12:"
                    f"{FLEET_CHAOS_STALL_S}s,kill_ingest_conn@p18")


def _fleet_chaos_leg(torch, dev, label="fleet_chaos"):
    """``train.main --actors 3 --phases 240 --fleet-heartbeat 2.5
    --chaos-spec kill_actor@p5,corrupt_frame@p8,stall_actor@p12:7s,
    kill_ingest_conn@p18 --obs-fleet 1`` at pendulum_r2d2, learner on the
    card: all 240 phases run, each fault is injected once and followed by
    its recovery in the merged flight dumps, env steps never go down, one
    compute process on the card, one scatter launch per learner step; the
    learner's final scrape reads the actor-side drill counts
    (``r2d2dpg_fleet_chaos_drills_total`` of ``stall_actor`` and
    ``corrupt_frame``, 1 each) through the TELEM mirror."""
    import threading

    from r2d2dpg_torch import kernels
    from r2d2dpg_torch.fleet.supervisor import ActorSupervisor
    from r2d2dpg_torch.obs import get_registry
    from r2d2dpg_torch.train import main as train_main

    tc = _config("pendulum_r2d2").trainer
    logdir = tempfile.mkdtemp(prefix=f"chip_smoke_{label}_")
    seen = {}
    done = threading.Event()
    plain_start = ActorSupervisor.start

    def start(self):
        seen["sup"] = self
        return plain_start(self)

    def watch():
        """Reads the card's processes and the actors' device files once
        the learner has trained."""
        while not done.wait(0.25):
            sup = seen.get("sup")
            if sup is not None and "probe" not in seen and kernels.PRIORITY_SCATTER.launches:
                seen["probe"] = {"compute_apps": _compute_apps(),
                                 "actor_card_fds": {i: _card_fds(pid)
                                                    for i, pid in sup.pids().items()}}

    ActorSupervisor.start = start
    watcher = threading.Thread(target=watch, name="chip-smoke-chaos-watch", daemon=True)
    buf = io.StringIO()
    drills0 = _drill_counts(get_registry())
    _fresh_telem_plane()
    try:
        for k in kernels.ALL_KERNELS:
            k.launches = 0
        lstm0 = _lstm_mark()
        watcher.start()
        t0, t0_wall = time.perf_counter(), time.time()
        with contextlib.redirect_stdout(buf):
            state = train_main([
                "--config", "pendulum_r2d2", "--actors", str(FLEET_ACTORS),
                "--phases", str(FLEET_CHAOS_PHASES), "--log-every", "5",
                "--seed", str(FLEET_CHAOS_SEED),
                "--fleet-heartbeat", str(FLEET_CHAOS_HEARTBEAT_S),
                "--chaos-spec", FLEET_CHAOS_SPEC, "--obs-fleet", "1", "--logdir", logdir,
            ])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels.ALL_KERNELS}
        _lstm_check(label, *_lstm_since(lstm0), True)  # pendulum_r2d2's learner
        events = _merged_events(logdir, t0_wall)
        with open(os.path.join(logdir, "metrics_final.prom")) as f:
            final_prom = f.read()
    finally:
        done.set()
        watcher.join()
        ActorSupervisor.start = plain_start
        shutil.rmtree(logdir, ignore_errors=True)
    lines = buf.getvalue().splitlines()
    stats_line = next(x for x in lines if x.startswith("fleet: ") and "wall_s" in x)
    words = stats_line.split()[1:]
    stats = {k: float(v) for k, v in zip(words[::2], words[1::2])}
    expected = FLEET_CHAOS_PHASES * tc.learner_steps
    if stats["train_phases"] != FLEET_CHAOS_PHASES or state.train.step != expected:
        raise AssertionError(f"{label}: {stats['train_phases']} phases, step "
                             f"{state.train.step}; expected {FLEET_CHAOS_PHASES}")
    if launches["priority_scatter"] != expected:
        raise AssertionError(f"{label}: scatter launches {launches}, expected {expected}")
    chaos = _check_chaos(label, FLEET_CHAOS_SPEC, events, lines,
                         _drill_counts(get_registry()), drills0)
    crc = lambda e: "FrameCRCError" in str(e.get("error", ""))  # noqa: E731
    target = {k: v["target"] for k, v in chaos.items()}
    dropped = next(e["dropped"] for e in events if e.get("fault") == "kill_ingest_conn")
    recovery = {
        "kill_actor": _recovery(label, events, "kill_actor", [
            ("actor_crash", target["kill_actor"], None),
            ("actor_restart", target["kill_actor"], None)]),
        "stall_actor": _recovery(label, events, "stall_actor", [
            ("peer_dead", target["stall_actor"], None),
            ("actor_reconnect", target["stall_actor"], None)]),
        "corrupt_frame": _recovery(label, events, "corrupt_frame", [
            ("ingest_conn_error", target["corrupt_frame"], crc),
            ("actor_reconnect", target["corrupt_frame"], None)]),
        "kill_ingest_conn": _recovery(label, events, "kill_ingest_conn", [
            ("actor_reconnect", dropped, None)]),
    }
    logged = [x for x in lines if x.startswith("phase ")]
    steps = _env_steps(logged)
    probe = seen.get("probe")
    # The actor-side drill counters, folded into the learner's scrape under
    # actor=/host= (the learner's own series carry no host label).
    mirrored = {(labels.get("actor"), labels.get("fault")): v
                for labels, v in _series(final_prom, "r2d2dpg_fleet_chaos_drills_total")
                if "host" in labels}
    actor_drills = {f: mirrored.get((str(chaos[f]["target"]), f))
                    for f in ("stall_actor", "corrupt_frame")}
    rec = {"flags": FLEET_CHAOS_SPEC, "seed": FLEET_CHAOS_SEED,
           "mirrored_actor_drills": actor_drills,
           "mirrored_drill_series": sorted(f"{a}:{f}={v}" for (a, f), v in mirrored.items()),
           "heartbeat_s": FLEET_CHAOS_HEARTBEAT_S, "train_phases": FLEET_CHAOS_PHASES,
           "run_seconds": seconds, "chaos": chaos, "recovery_s": recovery,
           "env_steps_logged": steps,
           "drain_phases_per_s": stats.get("train_drain_phases_per_sec"),
           "drain_learn_ms": [stats["drain_learn_p50_ms"], stats["drain_learn_p99_ms"]],
           "sheds": stats["sheds"], "restarts": stats["actor_restarts"],
           "probe": probe, "stats": stats, "scatter_launches": launches["priority_scatter"]}
    print("fleet chaos stats line:", stats_line, flush=True)
    print(json.dumps({label: rec}), flush=True)
    if steps != sorted(steps) or not steps or steps[-1] <= 0:
        raise AssertionError(f"{label}: env steps went down: {steps}")
    if any(v != 1.0 for v in actor_drills.values()):
        raise AssertionError(f"{label}: actor-side drill counts through the mirror "
                             f"{actor_drills}, expected 1 each")
    if probe is None or len(probe["compute_apps"]) != 1 or any(
            probe["actor_card_fds"].values()):
        raise AssertionError(f"{label}: card processes {probe}")
    return {label: launches["priority_scatter"]}


# The autoscaled central drain: 2 actors, the supervisor in policy mode, the
# policy loop on /health.  Seed 0 gives the two faults different actors
# (kill actor 1 at drain phase 5, stall actor 0 at its 70th batch).  The
# cooldown outlasts a replacement's start-up (its first SEQS about 7 s
# after its spawn on an H100 host), so the killed actor's staleness,
# which runs on until its successor's HELLO, never gets that successor
# replaced as well; the stall outlasts its detection (6 s stale, 2
# evaluations 0.5 s apart) plus that cooldown.  A replacement re-arms
# its actor-side drills: the stalled actor's successor would stall again
# at its own 70th batch, so the run ends by phases (each drains one
# batch), about 50 after that successor's first SEQS, before it gets
# there.  Since the learner step replays as a CUDA graph the learner waits
# on the actors, ~25 drain phases a second for each actor streaming; and
# since the LSTM unrolls run the recurrence kernel, the window of no
# actor (the killed one starting again, the other stalled) drains nothing
# and the phases that remain go faster: on an H100 host 300 phases ended
# 26 s in, 4 s after the stalled actor's successor was spawned and before
# its first SEQS (~7 s after a spawn: near phase 390 at that rate); its
# 70th batch comes ~130 phases after that, so the run ends at 450.  The
# first fleet run of a process pays ~9 s of imports in its first drain and
# misses the window; chip_smoke.py and probes/chaos_legs.py run this leg
# after another fleet leg.
FLEET_AUTOSCALE_ACTORS = 2
FLEET_AUTOSCALE_PHASES = 450
FLEET_AUTOSCALE_STALE_S = 6
FLEET_AUTOSCALE_COOLDOWN_S = 12
FLEET_AUTOSCALE_SPEC = "kill_actor@p5,stall_actor@p70:20s"
FLEET_AUTOSCALE_FLAGS = (
    "--obs-fleet", "1", "--obs-port", "0", "--obs-host", "127.0.0.1",
    "--autoscale", "1", "--autoscale-every", "0.5", "--autoscale-fire", "2",
    "--autoscale-cooldown", str(FLEET_AUTOSCALE_COOLDOWN_S),
    "--health-stale-after", str(FLEET_AUTOSCALE_STALE_S),
    "--fleet-heartbeat", str(FLEET_CHAOS_HEARTBEAT_S),
    "--chaos-spec", FLEET_AUTOSCALE_SPEC,
)


TELEM_FRESH_S = 3.0  # a live actor's or shard's TELEM staleness on the scrape


def _first_seqs_after(seqs, actor, t):
    """When actor ``actor``'s sequence count first rose after time ``t``
    (the 0.1 s samples of the learner's ``r2d2dpg_fleet_sequences_total``),
    or None."""
    base = None
    for ts, counts in seqs:
        v = counts.get(actor, 0.0)
        if ts <= t:
            base = v
        elif base is None:
            base = v
        elif v > base:
            return ts
    return None


def _fleet_autoscale_leg(torch, dev, label="fleet_autoscale"):
    """``train.main --actors 2 --phases 300 --obs-fleet 1 --autoscale 1``
    under ``kill_actor@p5,stall_actor@p70:20s`` at pendulum_r2d2, learner
    on the card, actors in policy mode: the kill is replaced by an
    ``actors_down`` decision (``spawn_actor``), the stall by a
    ``telem_stale`` one (``replace_actor`` of the stalled actor), never by
    the restart ladder; both actors alive at the end with a final /health
    free of ``actors_down`` and ``telem_stale``; every live actor's series
    on the learner's /metrics under ``actor=``/``host=`` with staleness
    under 3 s outside the faults while the learner runs; env steps never
    down, no shed; one
    scatter launch per learner step; one compute process on the card."""
    import threading

    from r2d2dpg_torch import kernels
    from r2d2dpg_torch.fleet.supervisor import ActorSupervisor
    from r2d2dpg_torch.obs import get_registry
    from r2d2dpg_torch.train import main as train_main

    logdir = tempfile.mkdtemp(prefix=f"chip_smoke_{label}_")
    seen = {"seqs": []}
    done = threading.Event()
    plain_start = ActorSupervisor.start
    reg = get_registry()

    def start(self):
        seen["sup"] = self
        return plain_start(self)

    def counts():
        snap = reg.snapshot().get("r2d2dpg_fleet_sequences_total", {"samples": []})
        return {s["labels"]["actor"]: s["value"] for s in snap["samples"]}

    def watch():
        """Samples each actor's sequence count every 0.1 s; reads the card's
        processes and the actors' device files once the learner trained."""
        steps = 0
        while not done.wait(0.1):
            seen["seqs"].append((time.time(), counts()))
            if kernels.PRIORITY_SCATTER.launches != steps:
                steps = kernels.PRIORITY_SCATTER.launches
                seen["t_last_step"] = time.time()
            sup = seen.get("sup")
            if sup is not None and "probe" not in seen and kernels.PRIORITY_SCATTER.launches:
                seen["probe"] = {"compute_apps": _compute_apps(),
                                 "actor_card_fds": {i: _card_fds(pid)
                                                    for i, pid in sup.pids().items()}}

    def actions():
        snap = reg.snapshot().get("r2d2dpg_autoscale_actions_total", {"samples": []})
        return {s["labels"]["action"]: s["value"] for s in snap["samples"]}

    ActorSupervisor.start = start
    watcher = threading.Thread(target=watch, name="chip-smoke-autoscale-watch",
                               daemon=True)
    buf = io.StringIO()
    scraper = _Scraper(logdir, ("/metrics", "/health"), 0.5)
    final = {}
    actions0, drills0 = actions(), _drill_counts(reg)
    _fresh_telem_plane()
    try:
        for k in kernels.ALL_KERNELS:
            k.launches = 0
        lstm0 = _lstm_mark()
        watcher.start()
        t0, t0_wall = time.perf_counter(), time.time()
        with scraper, contextlib.redirect_stdout(buf):
            state = train_main([
                "--config", "pendulum_r2d2", "--actors", str(FLEET_AUTOSCALE_ACTORS),
                "--phases", str(FLEET_AUTOSCALE_PHASES), "--log-every", "10",
                "--logdir", logdir, *FLEET_AUTOSCALE_FLAGS,
            ])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels.ALL_KERNELS}
        _lstm_check(label, *_lstm_since(lstm0), True)  # pendulum_r2d2's learner
        events = _merged_events(logdir, t0_wall)
        for name in ("health_final.json", "metrics_final.prom"):
            with open(os.path.join(logdir, name)) as f:
                final[name] = f.read()
    finally:
        done.set()
        watcher.join()
        ActorSupervisor.start = plain_start
        shutil.rmtree(logdir, ignore_errors=True)
    moved = {k: v - actions0.get(k, 0.0) for k, v in actions().items()}
    lines = buf.getvalue().splitlines()
    stats_line = next(x for x in lines if x.startswith("fleet: ") and "wall_s" in x)
    words = stats_line.split()[1:]
    stats = {k: float(v) for k, v in zip(words[::2], words[1::2])}
    print("fleet autoscale stats line:", stats_line, flush=True)
    chaos = _check_chaos(label, FLEET_AUTOSCALE_SPEC, events, lines, _drill_counts(reg),
                         drills0)
    killed, stalled = chaos["kill_actor"]["target"], chaos["stall_actor"]["target"]
    fired = lambda rule, slot: (lambda e: e.get("fired") and e.get("rule") == rule  # noqa: E731
                                and e.get("slot") == slot)
    by_policy = lambda e: e.get("origin") == "autoscale"  # noqa: E731
    acted = lambda kind, slot: (lambda e: e.get("action") == kind  # noqa: E731
                                and e.get("slot") == slot)
    recovery = {
        "kill_actor": _recovery(label, events, "kill_actor", [
            ("actor_crash", killed, None),
            ("autoscale_decision", None, fired("actors_down", killed)),
            ("actor_spawn", killed, by_policy),
            ("autoscale_action", None, acted("spawn_actor", killed))]),
        "stall_actor": _recovery(label, events, "stall_actor", [
            ("autoscale_decision", None, fired("telem_stale", stalled)),
            ("actor_spawn", stalled, by_policy),
            ("autoscale_action", None, acted("replace_actor", stalled))]),
    }
    # Each fault's window: its injection to its new incarnation's first
    # SEQS (the seconds the recovery line prints).
    windows = {}
    for fault, who in (("kill_actor", killed), ("stall_actor", stalled)):
        t_inj = chaos[fault]["t_wall"]
        t_act = next(e["t_wall"] for e in events if e["kind"] == "autoscale_action"
                     and e.get("slot") == who and e["t_wall"] >= t_inj)
        t_seqs = _first_seqs_after(seen["seqs"], str(who), t_act)
        windows[fault] = (t_inj, t_seqs)
        recovery[fault].update(
            inject_to_action_s=t_act - t_inj,
            action_to_first_seqs_s=None if t_seqs is None else t_seqs - t_act)
    # /metrics outside the faults, once both actors streamed and until the
    # last learner step (then the teardown: the drain stops, the handlers
    # hold their acks, and no actor pushes TELEM until the supervisor stops).
    ids = [str(i) for i in range(FLEET_AUTOSCALE_ACTORS)]
    t_first = max((_first_seqs_after(seen["seqs"], a, 0.0) or float("inf")) for a in ids)
    t_end = seen.get("t_last_step", float("inf"))
    polls, quiet = [], []
    for t, path, status, _, body in scraper.samples:
        if path != "/metrics" or status != 200:
            continue
        stale = {lab["actor"]: v for lab, v in
                 _series(body, "r2d2dpg_fleet_telem_staleness_seconds")}
        mirrored = {lab["actor"] for lab, _ in
                    _series(body, "r2d2dpg_actor_phases_total") if "host" in lab}
        polls.append((t, stale, mirrored))
        if t_first <= t <= t_end and not any(a <= t <= (b or float("inf"))
                                             for a, b in windows.values()):
            quiet.append((t, stale, mirrored))
    health = json.loads(final["health_final.json"])
    final_rules = {f["rule"] for f in health.get("findings", ())}
    logged = [x for x in lines if x.startswith("phase ")]
    steps = _env_steps(logged)
    probe = seen.get("probe")
    decisions = [e for e in events if e["kind"] == "autoscale_decision"]
    _stall_report(label, events, t0_wall)
    rec = {
        "flags": [*FLEET_AUTOSCALE_FLAGS, "--phases", FLEET_AUTOSCALE_PHASES],
        "actors": FLEET_AUTOSCALE_ACTORS, "run_seconds": seconds,
        "train_phases": stats["train_phases"], "learner_steps": state.train.step,
        "chaos": chaos, "recovery_s": recovery,
        "autoscale_actions_moved": moved,
        "autoscale_decisions": [(round(e["t_wall"] - t0_wall, 3), e.get("action"),
                                 e.get("slot"), e.get("rule"), e.get("gated_by"))
                                for e in decisions],
        "restarts": stats["actor_restarts"], "sheds": stats["sheds"],
        "final_alive": _metric(final["metrics_final.prom"], "r2d2dpg_fleet_actors_alive"),
        "health_final": health, "env_steps_logged": steps,
        "metrics_polls": len(polls), "quiet_polls": len(quiet),
        "max_quiet_staleness_s": max((max(st.get(a, float("inf")) for a in ids)
                                      for _, st, _ in quiet), default=None),
        "quiet_polls_over_limit": [
            (round(t - t0_wall, 3), st) for t, st, _ in quiet
            if max(st.get(a, float("inf")) for a in ids) >= TELEM_FRESH_S][:10],
        "first_seqs_both_s": t_first - t0_wall,
        "last_step_s": t_end - t0_wall,
        "fault_windows_s": {f: [round(a - t0_wall, 3), None if b is None else round(b - t0_wall, 3)]
                            for f, (a, b) in windows.items()},
        "drain_phases_per_s": stats.get("train_drain_phases_per_sec"),
        "drain_learn_ms": [stats["drain_learn_p50_ms"], stats["drain_learn_p99_ms"]],
        "probe": probe, "stats": stats, "scatter_launches": launches["priority_scatter"],
    }
    print(json.dumps({label: rec}), flush=True)
    print(json.dumps({f"{label}_recovery_s": {
        f: {"inject_to_action_s": r["inject_to_action_s"],
            "action_to_first_seqs_s": r["action_to_first_seqs_s"]}
        for f, r in recovery.items()}}), flush=True)
    problems = []
    if (launches["priority_scatter"] != state.train.step
            or stats["train_phases"] != FLEET_AUTOSCALE_PHASES):
        problems.append(f"scatter launches {launches}, learner steps {state.train.step}, "
                        f"phases {stats['train_phases']}")
    if stats["actor_restarts"] != 0:
        problems.append(f"{stats['actor_restarts']} ladder restarts, expected 0")
    if {k: v for k, v in moved.items() if v} != {"spawn_actor": 1.0, "replace_actor": 1.0}:
        problems.append(f"autoscale actions {moved}, expected one spawn and one replace")
    if rec["final_alive"] != FLEET_AUTOSCALE_ACTORS or final_rules & {"actors_down",
                                                                     "telem_stale"}:
        problems.append(f"final: alive {rec['final_alive']}, health {health}")
    if steps != sorted(steps) or not steps or steps[-1] <= 0:
        problems.append(f"env steps went down: {steps}")
    if stats["sheds"] != 0:
        problems.append(f"{stats['sheds']} sheds")
    if any(w[1] is None for w in windows.values()):
        problems.append(f"a replacement never sent SEQS: {windows}")
    if not quiet or any(set(ids) - m for _, _, m in quiet):
        problems.append("an actor's series missing under actor=/host= on a quiet poll")
    if rec["max_quiet_staleness_s"] is None or (
            rec["max_quiet_staleness_s"] >= TELEM_FRESH_S):
        problems.append(f"TELEM staleness {rec['max_quiet_staleness_s']} s outside the faults")
    if probe is None or len(probe["compute_apps"]) != 1 or any(
            probe["actor_card_fds"].values()):
        problems.append(f"card processes {probe}")
    if problems:
        raise AssertionError(f"{label}: {problems}")
    return {label: launches["priority_scatter"]}


FLEET_DP1_PHASES = 20
FLEET_DP1_WINDOW = (4, 3)  # --profile-window P:N: drain-learn phases P..P+N-1


def _window_collectives(logdir):
    """The profile window's collectives: host-side ops named ``nccl:*``
    (``gloo:*`` on the CPU; one per collective call) and the NCCL device
    kernels, by name."""
    (trace_name,) = os.listdir(os.path.join(logdir, "profile_window"))
    with open(os.path.join(logdir, "profile_window", trace_name)) as f:
        trace = json.load(f)["traceEvents"]
    host, device = {}, {}
    for e in trace:
        name = e.get("name", "")
        if e.get("cat") == "kernel" and COLLECTIVE_EVENTS["nccl_kernels"](name.lower()):
            device[name] = device.get(name, 0) + 1
        elif e.get("ph") == "X" and name.startswith(("nccl:", "gloo:")):
            host[name] = host.get(name, 0) + 1
    return host, device


def _fleet_dp1_leg(torch, dev, label="fleet_dp1"):
    """``train.main --config pendulum_r2d2 --actors 2 --learner-dp 1
    --phases 20``: the fleet's central drain into the dp learner on a
    world of one, through rank 0's broadcast path (``parallel/control.py``).
    Every staged batch goes through ``DPLearnerTrainer._put_staged``
    (counted), one control record and one payload broadcast go out for
    each absorb and each drain-learn, and one STOP record at the end; the
    scatter launches once per drain-learn step (counts set to 0 just
    before and read just after), the run prints the topology stamp, and the
    dp gauges read the drain width and the arena's size.  A profile window
    over drain-learn phases 4..6 records the collectives (host ops and
    NCCL kernels).  Sheds are recorded, inside the window (starting the
    profiler pauses the drain) and outside it, and not held: they follow
    the host's speed."""
    from r2d2dpg_torch import kernels
    from r2d2dpg_torch.obs import get_flight_recorder, get_registry
    from r2d2dpg_torch.parallel import DPLearnerTrainer
    from r2d2dpg_torch.train import main as train_main

    tc = _config("pendulum_r2d2").trainer
    flags = ("--actors", "2", "--learner-dp", "1")
    logdir = tempfile.mkdtemp(prefix=f"chip_smoke_{label}_")
    placed = []
    plain_put = DPLearnerTrainer._put_staged

    def put(self, staged, axis=0):
        placed.append(axis)
        return plain_put(self, staged, axis)

    DPLearnerTrainer._put_staged = put
    buf = io.StringIO()
    try:
        for k in kernels.ALL_KERNELS:
            k.launches = 0
        lstm0 = _lstm_mark()
        t0, t0_mono = time.perf_counter(), time.monotonic()
        with _group_of_one(), contextlib.redirect_stdout(buf):
            state = train_main([
                "--config", "pendulum_r2d2", "--phases", str(FLEET_DP1_PHASES),
                "--log-every", str(FLEET_DP1_PHASES // 2), "--logdir", logdir,
                "--profile-window", "%d:%d" % FLEET_DP1_WINDOW, *flags,
            ])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels.ALL_KERNELS}
        _lstm_check(label, *_lstm_since(lstm0), True)  # pendulum_r2d2's learner
        lines = buf.getvalue().splitlines()
        stamp = _stamp_checked(label, flags, lines, logdir)
        host_ops, nccl_kernels = _window_collectives(logdir)
    finally:
        DPLearnerTrainer._put_staged = plain_put
        shutil.rmtree(logdir, ignore_errors=True)
    # Sheds against the profile window: starting the profiler pauses the
    # drain, and a handler sheds after 1 s (--fleet-shed-after) of a full
    # queue, so a shed up to 1 s past the window's end is the window's.
    events = [e for e in get_flight_recorder().events() if e["t_mono"] >= t0_mono]
    marks = {e["kind"]: e["t_mono"] for e in events
             if e["kind"] in ("profile_start", "profile_stop")}
    sheds = [e["t_mono"] for e in events if e["kind"] == "shed"]
    in_window = [t for t in sheds
                 if marks.get("profile_start", math.inf) <= t <= marks.get("profile_stop", -1) + 1.0]
    expected = FLEET_DP1_PHASES * tc.learner_steps
    reg = get_registry()
    stats_line = next(x for x in lines if x.startswith("fleet: ") and "wall_s" in x)
    words = stats_line.split()[1:]
    stats = {k: float(v) for k, v in zip(words[::2], words[1::2])}
    rec = {"flags": list(flags), "train_phases": FLEET_DP1_PHASES, "run_seconds": seconds,
           "topology": stamp, "scatter_launches": launches["priority_scatter"],
           "put_staged_calls": len(placed), "put_staged_axes": sorted(set(placed)),
           "learn_width": reg.get("r2d2dpg_dp_shard_learn_width").value,
           "shard_occupancy": reg.get("r2d2dpg_dp_shard_occupancy").labels(shard="0").value,
           "arena_size": min(state.arena.total_added, tc.capacity),
           "drain_phases_per_s": stats.get("train_drain_phases_per_sec"),
           "sheds": stats.get("sheds"), "restarts": stats.get("actor_restarts"),
           "learner_step": state.train.step,
           "absorb_drains": stats.get("absorb_drains"),
           "control_records": stats.get("control_records"),
           "payload_broadcasts": stats.get("payload_broadcasts"),
           "window_phases": FLEET_DP1_WINDOW[1],
           "window_host_collectives": host_ops, "window_nccl_kernels": nccl_kernels,
           "window_seconds": marks.get("profile_stop", 0) - marks.get("profile_start", 0),
           "sheds_in_window": len(in_window), "sheds_outside_window": len(sheds) - len(in_window)}
    print(json.dumps({label: rec}), flush=True)
    # One record and one payload per absorb and drain-learn, and the STOP.
    if (rec["payload_broadcasts"] != rec["absorb_drains"] + FLEET_DP1_PHASES
            or rec["control_records"] != rec["payload_broadcasts"] + 1):
        raise AssertionError(f"{label}: control broadcasts {rec}")
    if not nccl_kernels:
        raise AssertionError(f"{label}: no NCCL kernel in the profile window")
    if launches["priority_scatter"] != expected or state.train.step != expected:
        raise AssertionError(f"{label}: scatter launches {launches}, step "
                             f"{state.train.step}, expected {expected}")
    # One placement per staged batch: the absorbed ones and the drained ones.
    if rec["put_staged_axes"] != [0] or len(placed) < expected:
        raise AssertionError(f"{label}: _put_staged calls {rec}")
    if rec["learn_width"] != tc.num_envs or rec["shard_occupancy"] != rec["arena_size"]:
        raise AssertionError(f"{label}: dp gauges {rec}")
    if not bool(torch.isfinite(state.arena.priority).all()):
        raise AssertionError(f"{label}: non-finite arena priorities")
    return {label: launches["priority_scatter"]}


SAMPLER_DP1_PHASES = 10


def _sampler_dp1_leg(torch, dev, label="sampler_dp1"):
    """``train.main --config pendulum_r2d2 --actors 2 --replay-shards 2
    --learner-dp 1 --phases 10``: the sampler's pull loop into the dp
    learner on a world of one, through rank 0's broadcast path.  Every
    pulled batch goes through ``DPLearnerTrainer._put_staged(axis=1)`` and
    its TD priorities through ``gather_priorities`` (both counted), one
    control record and one payload broadcast go out per pull-learn and a
    STOP at the end, the scatter never launches (no device arena), and the
    pull-learn rate is recorded beside the loopback leg's of this run."""
    from r2d2dpg_torch import kernels
    from r2d2dpg_torch.fleet import sampler as sampler_mod
    from r2d2dpg_torch.parallel import DPLearnerTrainer
    from r2d2dpg_torch.train import main as train_main
    from r2d2dpg_torch.tree import tree_leaves

    tc = _config("pendulum_r2d2").trainer
    flags = ("--actors", "2", "--replay-shards", "2", "--learner-dp", "1")
    logdir = tempfile.mkdtemp(prefix=f"chip_smoke_{label}_")
    placed, gathered = [], []
    plain_put, plain_gather = DPLearnerTrainer._put_staged, sampler_mod.gather_priorities

    def put(self, staged, axis=0):
        placed.append(axis)
        return plain_put(self, staged, axis)

    def gather(t, prios):
        out = plain_gather(t, prios)
        gathered.append(tuple(out.shape))
        return out

    DPLearnerTrainer._put_staged, sampler_mod.gather_priorities = put, gather
    buf = io.StringIO()
    try:
        for k in kernels.ALL_KERNELS:
            k.launches = 0
        lstm0 = _lstm_mark()
        t0 = time.perf_counter()
        with _group_of_one(), contextlib.redirect_stdout(buf):
            state = train_main([
                "--config", "pendulum_r2d2", "--phases", str(SAMPLER_DP1_PHASES),
                "--log-every", str(SAMPLER_DP1_PHASES // 2), "--logdir", logdir, *flags,
            ])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels.ALL_KERNELS}
        _lstm_check(label, *_lstm_since(lstm0), True)  # pendulum_r2d2's learner
        lines = buf.getvalue().splitlines()
        stamp = _stamp_checked(label, flags, lines, logdir)
    finally:
        DPLearnerTrainer._put_staged, sampler_mod.gather_priorities = plain_put, plain_gather
        shutil.rmtree(logdir, ignore_errors=True)
    words = next(x for x in lines if x.startswith("fleet: ") and "wall_s" in x).split()[1:]
    stats = {k: float(v) for k, v in zip(words[::2], words[1::2])}
    kb = (tc.learner_steps, tc.batch_size)
    rec = {"flags": list(flags), "train_phases": SAMPLER_DP1_PHASES, "run_seconds": seconds,
           "topology": stamp, "scatter_launches": launches["priority_scatter"],
           "put_staged_axes": sorted(set(placed)), "put_staged_calls": len(placed),
           "priority_gathers": len(gathered), "gathered_shapes": sorted(set(gathered)),
           "control_records": stats.get("control_records"),
           "payload_broadcasts": stats.get("payload_broadcasts"),
           "pull_learn_phases_per_s": stats.get("train_phases_per_sec"),
           "loopback_leg_phases_per_s": PULL_RATES.get("sampler_loopback"),
           "pull_learn_ms": [stats.get("pull_learn_p50_ms"), stats.get("pull_learn_p99_ms")],
           "put_ms": [stats.get("put_p50_ms"), stats.get("put_p99_ms")],
           "prio_fetch_ms": [stats.get("prio_fetch_p50_ms"), stats.get("prio_fetch_p99_ms")],
           "sheds": stats.get("sheds"), "evictions": stats.get("evictions"),
           "learner_step": state.train.step}
    print(json.dumps({label: rec}), flush=True)
    n = SAMPLER_DP1_PHASES
    if launches["priority_scatter"] or state.train.step != n * tc.learner_steps:
        raise AssertionError(f"{label}: launches {launches}, step {state.train.step}")
    if (rec["put_staged_axes"] != [1] or len(placed) != n or len(gathered) != n
            or rec["gathered_shapes"] != [kb]):
        raise AssertionError(f"{label}: placement and gathers {rec}")
    if rec["payload_broadcasts"] != n or rec["control_records"] != n + 1:
        raise AssertionError(f"{label}: control broadcasts {rec}")
    if rec["sheds"] != 0 or rec["evictions"] != 0:
        raise AssertionError(f"{label}: sheds/evictions {rec}")
    if not all(bool(torch.isfinite(x).all()) for x in tree_leaves(state.train.actor_params)):
        raise AssertionError(f"{label}: non-finite params")
    return {label: launches["priority_scatter"]}


LIFECYCLE_PHASES = (10, 5)  # train phases before and after the resume
LIFECYCLE_MIN_REPLAY = 100  # depth cut: 25 fill phases instead of 50


def _eval_lines(lines):
    return [json.loads(x[len("eval "):]) for x in lines if x.startswith("eval ")]


def _mesh_lifecycle1_leg(torch, dev, label="mesh_lifecycle1"):
    """Checkpoints, resume and evals of the mesh trainers on a world of one,
    ``--learner-dp 1`` then ``--spmd 1``: ``train.main --config
    pendulum_r2d2 --checkpoint-dir D --checkpoint-every 5 --eval-every 5
    --phases 10``, then ``--resume --phases 5``, against the uninterrupted
    ``--phases 15`` run with the same ``--eval-every 5``; every run with
    ``--min-replay 100`` (a depth cut: 25 fill phases, not 50).  The final params
    and priorities must be bitwise equal, and so must the eval lines: the
    first two to the uninterrupted run's at the same phases, the resumed
    run's one (a resumed run's eval stream restarts at ``seed + 1``, as
    JAX's eval key does) to an ``Evaluator`` run on the uninterrupted run's
    final params with ``Draws(seed + 1)``.  The scatter launches once per
    learner step in every run (counts set to 0 just before and read just
    after each).  Save and restore seconds and the bytes of a checkpoint
    step are recorded."""
    from r2d2dpg_torch import kernels
    from r2d2dpg_torch import train as train_mod
    from r2d2dpg_torch.kernels import PRIORITY_SCATTER
    from r2d2dpg_torch.training.draws import Draws
    from r2d2dpg_torch.training.evaluator import Evaluator
    from r2d2dpg_torch.tree import tree_leaves
    from r2d2dpg_torch.utils import checkpoint as ck_mod

    config = _config("pendulum_r2d2")
    tc = config.trainer
    first, second = LIFECYCLE_PHASES
    timings = {}
    plain_save, plain_resume = ck_mod.CheckpointManager.save, train_mod.resume_state

    def save(self, step, state, trainer=None):
        t = time.perf_counter()
        plain_save(self, step, state, trainer)
        timings.setdefault("save_s", []).append(time.perf_counter() - t)

    def resume(trainer, ckpt):
        t = time.perf_counter()
        out = plain_resume(trainer, ckpt)
        torch.cuda.synchronize()
        timings.setdefault("restore_s", []).append(time.perf_counter() - t)
        return out

    def run(name, flags, argv):
        for k in kernels.ALL_KERNELS:
            k.launches = 0
        lstm0 = _lstm_mark()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with _group_of_one(), contextlib.redirect_stdout(buf):
            state = train_mod.main(["--config", "pendulum_r2d2", "--log-every", "16",
                                    "--min-replay", str(LIFECYCLE_MIN_REPLAY),
                                    "--eval-every", "5", *flags, *argv])
        torch.cuda.synchronize()
        _lstm_check(name, *_lstm_since(lstm0), _float32_lstm(config))
        return (state, buf.getvalue().splitlines(), time.perf_counter() - t0,
                PRIORITY_SCATTER.launches)

    env = config.env_factory(dev)
    evaluator = Evaluator(env, config.build_agent(env).actor, 10)  # train's --eval-envs
    ck_mod.CheckpointManager.save, train_mod.resume_state = save, resume
    launches = 0
    try:
        for part, flags in (("learner_dp1", ("--learner-dp", "1")),
                            ("spmd1", ("--spmd", "1"))):
            ckdir = tempfile.mkdtemp(prefix=f"chip_smoke_{label}_{part}_")
            timings.clear()
            try:
                whole, whole_lines, whole_s, whole_n = run(
                    f"{label}_{part}_whole", flags, ["--phases", str(first + second)])
                _, first_lines, first_s, first_n = run(
                    f"{label}_{part}_first", flags,
                    ["--phases", str(first), "--checkpoint-dir", ckdir,
                     "--checkpoint-every", "5"])
                saves = list(timings.get("save_s", []))
                step_bytes = _dir_bytes(os.path.join(
                    ckdir, str(ck_mod.latest_step(ckdir))))
                resumed, res_lines, res_s, res_n = run(
                    f"{label}_{part}_resumed", flags,
                    ["--phases", str(second), "--checkpoint-dir", ckdir, "--resume"])
            finally:
                shutil.rmtree(ckdir, ignore_errors=True)
            pairs = list(zip(tree_leaves(whole.train), tree_leaves(resumed.train), strict=True))
            want = _eval_lines(whole_lines)
            got = _eval_lines(first_lines) + _eval_lines(res_lines)
            fresh = evaluator.run(whole.train.actor_params, Draws(tc.seed + 1, dev))
            rec = {
                "flags": list(flags), "phases": [first, second],
                "params_bitwise": all(torch.equal(a, b) for a, b in pairs),
                "priorities_bitwise": torch.equal(whole.arena.priority,
                                                  resumed.arena.priority),
                "eval_phases": [e["phase"] for e in got],
                "evals_bitwise": got[:2] == want[:2] and all(
                    got[2][k] == v for k, v in fresh.items()),
                "eval_lines": got, "whole_eval_lines": want,
                "run_seconds": {"whole": whole_s, "first": first_s, "resumed": res_s},
                "save_s": saves, "resume_save_s": timings.get("save_s", [])[len(saves):],
                "restore_s": timings.get("restore_s"),
                "checkpoint_step_bytes": step_bytes,
                "scatter_launches": {"whole": whole_n, "first": first_n, "resumed": res_n},
            }
            print(json.dumps({f"{label}_{part}": rec}), flush=True)
            k = tc.learner_steps
            if (whole_n, first_n, res_n) != ((first + second) * k, first * k, second * k):
                raise AssertionError(f"{label} {part}: scatter launches {rec}")
            if not (rec["params_bitwise"] and rec["priorities_bitwise"]):
                raise AssertionError(f"{label} {part}: resume not bitwise: {rec}")
            if len(got) != 3 or [e["phase"] for e in want] != rec["eval_phases"]:
                raise AssertionError(f"{label} {part}: eval lines {rec}")
            if not rec["evals_bitwise"]:
                raise AssertionError(f"{label} {part}: eval lines differ: {rec}")
            launches += whole_n + first_n + res_n
    finally:
        ck_mod.CheckpointManager.save, train_mod.resume_state = plain_save, plain_resume
    return {label: launches}


def _fleet_phase(torch, dev):
    """The fleet main path: both legs, then the card-vs-CPU drain."""
    launches = _fleet_leg(torch, dev, "fleet_f32", ())
    launches.update(_fleet_leg(torch, dev, "fleet_bf16_zlib", (
        "--fleet-wire", "bf16", "--fleet-compress", "zlib", "--drain-coalesce", "2")))
    launches.update(_fleet_chaos_leg(torch, dev))
    _fleet_card_vs_cpu(torch, dev)
    return launches


PULL_RATES = {}  # each sampler leg's pull-learn phases/s, by label
SAMPLER_TRAIN_PHASES = 60  # pull-learn phases of the loopback leg
# The shard-procs leg runs longer: the killed shard process restarts on a
# host whose cores the free-running actors keep busy, and its restart
# (``import torch`` included) took over 20 s there, past 60 phases, and
# past 150 once the learner step replayed as a CUDA graph (~15 pull
# phases a second), and past 600 once the LSTM unrolls ran the
# recurrence kernel (about twice as many pull phases a second).
SAMPLER_PROCS_TRAIN_PHASES = 1500
SAMPLER_SHARDS = 2
SAMPLER_KILL_AT = 20  # learner steps before a shard process is killed
SAMPLER_KILL_SPEC = f"kill_shard@p{SAMPLER_KILL_AT}"
# The shard-procs leg: one process killed, the tier's TELEM on the scrape.
SAMPLER_KILL_FLAGS = ("--shard-procs", str(SAMPLER_SHARDS), "--chaos-spec",
                      SAMPLER_KILL_SPEC, "--obs-fleet", "1")
SAMPLER_CARD_VS_CPU_K = 4  # learner steps per pulled batch (K loop > 1)
SAMPLER_CARD_VS_CPU_RTOL = 1e-4  # of each tensor's largest |value|
# The direct data plane under the five sampler-path faults.  The two the
# actors and the shard processes fire run on their own clocks (actor 2's
# batches, shard process 1's absorbed SEQS frames; seed 0), which these
# never-backpressured actors advance faster than the pull clock: at 30
# batches and 40 frames both land early in training, after every data leg
# has been dialed.  The run has to outlast the learner-side faults'
# recoveries too: 20 phases after kill_sampler_conn@p40 did not, once the
# learner step replayed as a CUDA graph; the run's phases doubled again
# with the pull rate once the LSTM unrolls ran the recurrence kernel.
DIRECT_CHAOS_PHASES = 400
DIRECT_CHAOS_SPEC = ("partition_data_plane@p30,stall_shard@p40:2s,partition_shard@p20,"
                     "stall_sampler@p30:1s,kill_sampler_conn@p40")
DIRECT_CHAOS_FLAGS = ("--shard-procs", str(SAMPLER_SHARDS), "--shard-direct", "1",
                      "--chaos-spec", DIRECT_CHAOS_SPEC)


def _sampler_leg(torch, dev, label, flags, phases=SAMPLER_TRAIN_PHASES):
    """``train.main --actors 3 --replay-shards 2`` at pendulum_r2d2, learner
    on the card.  With ``--chaos-spec`` in ``flags`` the run directory's
    flight dumps are fused by the merge CLI and every fault is paired with
    its recovery: ``kill_shard`` (the shard-procs leg) and the direct
    data plane's five (``--shard-direct 1``).  Launch counts are set to 0
    just before and read just after; the scatter must not launch."""
    import threading

    from r2d2dpg_torch import kernels
    from r2d2dpg_torch.fleet.sampler import SamplerLearner
    from r2d2dpg_torch.fleet.shard import ShardProcTier
    from r2d2dpg_torch.fleet.supervisor import ActorSupervisor
    from r2d2dpg_torch.obs import get_registry
    from r2d2dpg_torch.train import main as train_main

    spec = flags[flags.index("--chaos-spec") + 1] if "--chaos-spec" in flags else ""
    kill = "kill_shard" in spec
    direct = "--shard-direct" in flags
    telem = "--obs-fleet" in flags
    tc = _config("pendulum_r2d2").trainer
    logdir = tempfile.mkdtemp(prefix=f"chip_smoke_{label}_")
    seen = {"sups": [], "pulls": [], "fwd": []}
    done = threading.Event()
    plain_sup_start, plain_tier_start = ActorSupervisor.start, ShardProcTier.start
    plain_pull = SamplerLearner._pull_phase_batches

    def sup_start(self):
        seen["sups"].append(self)
        return plain_sup_start(self)

    def tier_start(self):
        seen["tier"] = self
        return plain_tier_start(self)

    def pull(self, n, rng, tr=None):
        out = plain_pull(self, n, rng, tr)
        seen["pulls"].append((time.time(), sorted(set(out[2][0].tolist())),
                              tuple(s.alive for s in self.shards.shards)
                              if self._remote else ()))
        return out

    def children():
        return {(sup.role, i): pid for sup in seen["sups"] for i, pid in sup.pids().items()}

    def watch():
        """Samples the children's CPU use and the learner's forwarded
        bytes; reads the card's processes and the children's device files
        after ``SAMPLER_KILL_AT`` learner steps."""
        usage, probe = {}, None
        while not done.wait(0.25):
            for key, pid in children().items():
                st = _proc_stat(pid)
                if st is not None:
                    usage[key + (pid,)] = st
            if "tier" in seen:
                seen["fwd"].append((time.time(), seen["tier"].shard_set.forward_bytes_total))
            if probe is None and len(seen["pulls"]) >= SAMPLER_KILL_AT:
                probe = {"at_learner_steps": len(seen["pulls"]),
                         "compute_apps": _compute_apps(),
                         "child_card_fds": {f"{r}{i}": _card_fds(pid)
                                            for (r, i), pid in children().items()},
                         "children": len(children())}
        seen["usage"], seen["probe"] = usage, probe

    ActorSupervisor.start, ShardProcTier.start = sup_start, tier_start
    SamplerLearner._pull_phase_batches = pull
    watcher = threading.Thread(target=watch, name="chip-smoke-sampler-watch", daemon=True)
    buf = io.StringIO()
    # The killed leg serves /health, polled every 0.2 s through the kill.
    obs_flags = ("--obs-port", "0", "--obs-host", "127.0.0.1") if kill else ()
    scraper = _Scraper(logdir, ("/health",) if kill else (), 0.2)
    # Under --obs-fleet, /metrics every 0.5 s: the shard TELEM fold.
    metrics = _Scraper(logdir, ("/metrics",) if telem else (), 0.5)
    final, events = {}, []
    drills0 = _drill_counts(get_registry())
    if telem:
        _fresh_telem_plane()
    try:
        for k in kernels.ALL_KERNELS:
            k.launches = 0
        lstm0 = _lstm_mark()
        watcher.start()
        t0, cpu0 = time.perf_counter(), sum(os.times()[:2])
        t0_wall = time.time()
        with scraper, metrics, contextlib.redirect_stdout(buf):
            state = train_main([
                "--config", "pendulum_r2d2", "--actors", str(FLEET_ACTORS),
                "--replay-shards", str(SAMPLER_SHARDS),
                "--phases", str(phases),
                "--log-every", str(max(phases // 6, 1)),
                "--logdir", logdir, *obs_flags, *flags,
            ])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        learner_cpu_s = sum(os.times()[:2]) - cpu0
        launches = {k.name: k.launches for k in kernels.ALL_KERNELS}
        _lstm_check(label, *_lstm_since(lstm0), True)  # pendulum_r2d2's learner
        for name in ("health_final.json", "metrics_final.prom"):
            path = os.path.join(logdir, name)
            if os.path.exists(path):
                with open(path) as f:
                    final[name] = f.read()
        if spec:
            events = _merged_events(logdir, t0_wall)
    finally:
        done.set()
        watcher.join()
        ActorSupervisor.start, ShardProcTier.start = plain_sup_start, plain_tier_start
        SamplerLearner._pull_phase_batches = plain_pull
        shutil.rmtree(logdir, ignore_errors=True)
    lines = buf.getvalue().splitlines()
    stats_line = next(x for x in lines if x.startswith("fleet: ") and "wall_s" in x)
    words = stats_line.split()[1:]
    stats = {k: float(v) for k, v in zip(words[::2], words[1::2])}
    probe, pulls = seen.get("probe"), seen["pulls"]
    expected = phases * tc.learner_steps
    if stats["train_phases"] != phases or state.train.step != expected:
        raise AssertionError(f"{label}: {stats['train_phases']} phases, step "
                             f"{state.train.step}; expected {phases}")
    if launches["priority_scatter"]:
        raise AssertionError(f"{label}: scatter launches {launches}, expected none "
                             "(no device arena on the sampler path)")
    if stats["sheds"] != 0 or stats["evictions"] != 0:
        raise AssertionError(f"{label}: sheds {stats['sheds']}, evictions "
                             f"{stats['evictions']}; expected 0")
    logged = [x for x in lines if x.startswith("phase ")]
    numbers = []
    for word in logged[-1].split()[3:]:
        try:
            numbers.append(float(word.strip("()")))
        except ValueError:
            continue
    if not all(math.isfinite(x) for x in numbers):
        raise AssertionError(f"{label}: non-finite metrics: {logged[-1]}")
    gaps = [b[0] - a[0] for a, b in zip(pulls, pulls[1:])]
    rec = {
        "flags": list(flags), "actors": FLEET_ACTORS, "shards": SAMPLER_SHARDS,
        "train_phases": phases, "run_seconds": seconds,
        "phases_per_s": stats.get("train_phases_per_sec"),
        "learner_steps_per_s": stats.get("train_learner_steps_per_sec"),
        "sample_ms": [stats["sample_p50_ms"], stats["sample_p99_ms"]],
        "sampler_wait_ms": [stats["sampler_wait_p50_ms"], stats["sampler_wait_p99_ms"]],
        "sampler_wait_total_s": stats["sampler_wait_total_s"],
        "absorb_s": stats["sampler_absorb_s"],
        "put_ms": [stats["put_p50_ms"], stats["put_p99_ms"]],
        "prio_fetch_ms": [stats["prio_fetch_p50_ms"], stats["prio_fetch_p99_ms"]],
        "pull_learn_ms": [stats["pull_learn_p50_ms"], stats["pull_learn_p99_ms"]],
        "bytes_per_trained_seq": stats["bytes_per_trained_seq"],
        "sample_bytes_total": stats["sample_bytes_total"],
        "trained_seqs_total": stats["trained_seqs_total"],
        "sheds": stats["sheds"], "evictions": stats["evictions"],
        "max_gap_between_phases_s": max(gaps) if gaps else None,
        "probe": probe, "host_cores": os.cpu_count(),
        "child_cpu": [{"child": f"{r}{i}", "pid": pid, "cpu_s": cpu, "threads": th}
                      for (r, i, pid), (cpu, th) in sorted(seen["usage"].items())],
        "learner_cpu_s": learner_cpu_s, "stats": stats,
        "scatter_launches": launches["priority_scatter"],
    }
    if spec:
        rec["chaos"] = _check_chaos(label, spec, events, lines, _drill_counts(get_registry()),
                                    drills0)
    if kill:
        rec.update(_kill_shard_record(label, events, pulls, stats, scraper, final))
        if telem:
            rec.update(_shard_telem_record(label, metrics.samples, rec, final,
                                           pulls[-1][0]))
    if direct:
        rec.update(_direct_record(label, events, pulls, seen["fwd"], seen["tier"], logged))
    print("sampler stats line:", stats_line, flush=True)
    print("last log line:", logged[-1], flush=True)
    print(json.dumps({label: rec}), flush=True)
    PULL_RATES[label] = rec["phases_per_s"]
    if probe is None or len(probe["compute_apps"]) != 1 or any(
            probe["child_card_fds"].values()):
        raise AssertionError(f"{label}: card processes {probe}")
    return {label: launches["priority_scatter"]}


def _merged_events(logdir, t0_wall):
    """The run directory's flight dumps (this process's ring dumped there
    first) fused by ``python -m r2d2dpg_torch.obs.flight merge``; the
    events of this run only (the ring also holds earlier legs')."""
    from r2d2dpg_torch.obs import get_flight_recorder

    get_flight_recorder().dump()
    out = os.path.join(logdir, "merged.jsonl")
    subprocess.run([sys.executable, "-m", "r2d2dpg_torch.obs.flight", "merge", logdir,
                    "-o", out], check=True, capture_output=True, text=True, timeout=300,
                   cwd=os.path.dirname(os.path.abspath(__file__)))
    with open(out) as f:
        events = [json.loads(x) for x in f if x.strip()]
    return [e for e in events if e.get("t_wall", 0.0) >= t0_wall]


def _drill_counts(registry):
    snap = registry.snapshot().get("r2d2dpg_fleet_chaos_drills_total")
    return {} if snap is None else {s["labels"]["fault"]: s["value"]
                                    for s in snap["samples"]}


def _after(events, t, kind, who=None, pred=None):
    """The first ``kind`` event at or after ``t`` (of actor or shard
    ``who`` when given), or None."""
    for e in events:
        if e["kind"] != kind or e["t_wall"] < t:
            continue
        if who is not None and str(e.get("actor", e.get("shard"))) != str(who):
            continue
        if pred is None or pred(e):
            return e
    return None


def _check_chaos(label, spec, events, lines, drills, drills0):
    """Each fault of ``spec`` injected exactly once (one ``chaos_inject``
    line), counted once by the learner's drill counter when the learner
    fires it, and no ``chaos_unfired`` event or warning."""
    from r2d2dpg_torch.fleet.chaos import LEARNER_FAULTS, parse_chaos_spec

    out = {}
    for f in parse_chaos_spec(spec):
        inj = [e for e in events if e["kind"] == "chaos_inject" and e["fault"] == f.kind]
        if len(inj) != 1:
            raise AssertionError(f"{label}: {f.kind}: {len(inj)} chaos_inject lines, "
                                 f"expected 1: {inj}")
        counted = drills.get(f.kind, 0.0) - drills0.get(f.kind, 0.0)
        if f.kind in LEARNER_FAULTS and counted != 1:
            raise AssertionError(f"{label}: {f.kind}: drill counter moved by {counted}")
        out[f.kind] = {"t_wall": inj[0]["t_wall"], "target": inj[0].get("actor"),
                       "file": inj[0].get("file"), "learner_drill_count": counted}
    unfired = [e for e in events if e["kind"] == "chaos_unfired"]
    warned = [x for x in lines if "chaos faults never fired" in x
              or "left no injection evidence" in x]
    if unfired or warned:
        raise AssertionError(f"{label}: unfired faults: {unfired} {warned}")
    return out


def _recovery(label, events, fault, steps):
    """Seconds from ``fault``'s injection to each recovery event of
    ``steps`` ((kind, who, pred) in order, each after the one before)."""
    inj = next(e for e in events if e["kind"] == "chaos_inject" and e["fault"] == fault)
    t, out = inj["t_wall"], {}
    for kind, who, pred in steps:
        hit = _after(events, t, kind, who, pred)
        if hit is None:
            raise AssertionError(f"{label}: {fault} at {inj['t_wall']}: no {kind} "
                                 f"(of {who}) after it")
        out[f"to_{kind}_s"] = hit["t_wall"] - inj["t_wall"]
        t = hit["t_wall"]
    return out


def _kill_shard_record(label, events, pulls, stats, scraper, final):
    """``kill_shard`` on the shard-procs leg: exactly one ``shard_dead``,
    one restart and one ``shard_rejoin`` under epoch 2 of the killed
    process's shard, every pull while it is down drawn from the survivor,
    and /health's ``shards_down`` (1 of 2) in between."""
    inj = next(e for e in events if e["kind"] == "chaos_inject"
               and e["fault"] == "kill_shard")
    victim, t_kill = int(inj["actor"]), inj["t_wall"]  # one shard a process
    deaths = [e for e in events if e["kind"] == "shard_dead"]
    rejoins = [e for e in events if e["kind"] == "shard_rejoin"]
    restarts = [e for e in events if e["kind"] == "shard_restart"]
    down = [p for p in pulls if p[2] and not p[2][victim]]
    rec = dict(
        killed_shard=victim, t_kill=t_kill,
        recovery=_recovery(label, events, "kill_shard", [
            ("shard_dead", victim, None), ("shard_crash", None, None),
            ("shard_restart", None, None), ("shard_rejoin", victim, None)]),
        shard_deaths=[(e["shard"], e["t_wall"]) for e in deaths],
        shard_rejoins=[(e["shard"], e["epoch"], e["previous_epoch"], e["t_wall"])
                       for e in rejoins],
        shard_restarts=stats["shard_restarts"],
        pulls_while_victim_down=len(down),
        shards_drawn_while_down=sorted({s for p in down for s in p[1]}),
        kill_to_rejoin_s=rejoins[0]["t_wall"] - t_kill if rejoins else None,
        kill_to_death_s=deaths[0]["t_wall"] - t_kill if deaths else None,
        kill_to_respawn_s=restarts[0]["t_wall"] - t_kill if restarts else None,
        phases_after_rejoin=(sum(p[0] > rejoins[0]["t_wall"] for p in pulls)
                             if rejoins else 0),
    )
    # /health between the kill and the rejoin: shards_down (1 of 2).
    t_rejoin = rejoins[0]["t_wall"] if rejoins else float("inf")
    polls = [(t, json.loads(body)) for t, _, status, _, body in scraper.samples
             if status == 200]
    seen = [(t, f) for t, b in polls if t_kill <= t <= t_rejoin
            for f in b["findings"] if f["rule"] == "shards_down"]
    health_final = (json.loads(final["health_final.json"])
                    if "health_final.json" in final else None)
    rec.update(
        health_polls=len(polls),
        health_verdicts=sorted({b["verdict"] for _, b in polls}),
        shards_down_seen=[(round(t - t_kill, 3), f["value"], f["threshold"])
                          for t, f in seen],
        health_final=health_final,
        final_shard_alive=_metric(final.get("metrics_final.prom", ""),
                                  "r2d2dpg_shard_alive"),
    )
    survivor = 1 - victim
    if ([d[0] for d in rec["shard_deaths"]] != [victim] or stats["shard_restarts"] != 1
            or [(r[0], r[1], r[2]) for r in rec["shard_rejoins"]] != [(victim, 2, 1)]):
        raise AssertionError(f"{label}: expected one shard_dead, one restart and "
                             f"one rejoin of shard {victim} under epoch 2: {rec}")
    if not rec["pulls_while_victim_down"] or rec["shards_drawn_while_down"] != [survivor]:
        raise AssertionError(f"{label}: quotas not drawn over the survivor: {rec}")
    if not any(v == 1.0 and th == 2.0 for _, v, th in rec["shards_down_seen"]):
        raise AssertionError(f"{label}: /health never read shards_down (1 of 2) "
                             f"between the kill and the rejoin: {rec}")
    final_rules = {f["rule"] for f in (rec["health_final"] or {}).get("findings", ())}
    if (rec["health_final"] is None or final_rules & {"shards_down", "actors_down"}
            or rec["final_shard_alive"] != 2.0):
        raise AssertionError(f"{label}: final evidence {rec['health_final']}, "
                             f"r2d2dpg_shard_alive {rec['final_shard_alive']}")
    return rec


def _shard_telem_record(label, samples, kill, final, t_end):
    """The shard TELEM fold through the ``kill_shard`` drill, read off the
    /metrics polls: both shard processes' series under ``shard=``/``host=``,
    each ``r2d2dpg_shard_telem_staleness_seconds`` under 3 s while both
    processes are up, the killed process's shard stale through the outage
    and under 3 s again once it rejoined under epoch 2.  Polls after
    ``t_end``, the last pull, are the teardown: a push folds on the
    learner's next read of that leg, and past the last pull nothing reads
    the legs, so every shard's clock grows until the tier stops."""
    victim, t_kill = str(kill["killed_shard"]), kill["t_kill"]
    t_rejoin = kill["shard_rejoins"][0][3]
    ids = {str(i) for i in range(SAMPLER_SHARDS)}
    polls = []
    for t, _, status, _, body in samples:
        if status != 200:
            continue
        stale = {lab["shard"]: v for lab, v in
                 _series(body, "r2d2dpg_shard_telem_staleness_seconds")}
        mirrored = {lab["shard"] for lab, _ in
                    _series(body, "r2d2dpg_replay_shard_occupancy") if "host" in lab}
        polls.append((t, stale, mirrored))
    both = [(t, st) for t, st, m in polls if ids <= set(st) and ids <= m]
    before = [st for t, st in both if t < t_kill]
    after = [st for t, st in both if t_rejoin < t <= t_end]
    outage = [st.get(victim) for t, st, _ in polls if t_kill < t < t_rejoin]
    final_hosts = {lab["shard"] for lab, _ in _series(
        final.get("metrics_final.prom", ""), "r2d2dpg_replay_shard_occupancy")
        if "host" in lab}
    rec = {"shard_telem": {
        "polls": len(polls), "polls_both_up_before_kill": len(before),
        "polls_both_up_after_rejoin": len(after),
        "max_staleness_both_up_s": max((max(st.values()) for st in before + after),
                                       default=None),
        "victim_max_staleness_outage_s": max((v for v in outage if v is not None),
                                             default=None),
        "victim_staleness_after_rejoin_s": [st[victim] for st in after[:5]],
        # The largest while both were up: (seconds from the kill, shard, s).
        "top_staleness_both_up": sorted(
            ((round(t - t_kill, 3), sid, v) for t, st in both
             if t < t_kill or t_rejoin < t <= t_end for sid, v in st.items()),
            key=lambda x: -x[2])[:5],
        "last_pull_after_kill_s": t_end - t_kill,
        "max_staleness_after_last_pull_s": max(
            (max(st.values()) for t, st in both if t > t_end), default=None),
        "final_mirrored_shards": sorted(final_hosts),
    }}
    r = rec["shard_telem"]
    if not before or not after or final_hosts != ids:
        raise AssertionError(f"{label}: the shard processes' series under shard=/host= "
                             f"missing from the scrape: {r}")
    if r["max_staleness_both_up_s"] >= TELEM_FRESH_S:
        raise AssertionError(f"{label}: shard TELEM stale while both were up: {r}")
    if (r["victim_max_staleness_outage_s"] or 0.0) <= TELEM_FRESH_S:
        raise AssertionError(f"{label}: the killed shard never read stale: {r}")
    return rec


def _env_steps(logged):
    return [float(x.split()[x.split().index("env_steps") + 1]) for x in logged]


def _direct_record(label, events, pulls, fwd, tier, logged):
    """The direct data plane under its faults: every actor dials its
    shard; the learner forwards 0 bytes until the partition; the partition
    falls back loudly and re-dials with the control connection whole;
    ``partition_shard`` reconnects under the same epoch; the stalls cost
    no shed and no reap; ``kill_sampler_conn``'s actor reconnects; env
    steps never go down."""
    dials = [e for e in events if e["kind"] == "data_plane_dialed"]
    first_dial = {}
    for e in dials:
        first_dial.setdefault(int(e["actor"]), e["t_wall"])
    part = next(e for e in events if e.get("fault") == "partition_data_plane"
                and e["kind"] == "chaos_inject")
    victim, t_part = int(part["actor"]), part["t_wall"]
    up = [(t, b) for t, b in fwd if max(first_dial.values(), default=t_part) <= t < t_part]
    fallback = _after(events, t_part, "data_plane_fallback", victim)
    redial = fallback and _after(events, fallback["t_wall"], "data_plane_dialed", victim)
    torn = fallback and redial and [
        e for e in events if e["kind"] == "actor_reconnect_wait"
        and str(e.get("actor")) == str(victim)
        and fallback["t_wall"] <= e["t_wall"] <= redial["t_wall"]]
    pshard = next(e for e in events if e.get("fault") == "partition_shard"
                  and e["kind"] == "chaos_inject")
    ps, t_ps = int(pshard["actor"]), pshard["t_wall"]
    restarted = [e for e in events if e["kind"] in (
        "shard_dead", "shard_rejoin", "shard_restart", "shard_crash")]
    reaped = [e for e in events if e["kind"] in ("peer_dead", "shard_peer_dead")]
    steps = _env_steps(logged)
    rec = {"direct": {
        "dialed_actors": sorted(first_dial),
        "data_plane_dials": len(dials),
        "forward_bytes_samples_while_up": len(up),
        "forward_bytes_while_up": max((b for _, b in up), default=None),
        "forward_bytes_final": fwd[-1][1] if fwd else None,
        "partitioned_actor": victim,
        "partition": _recovery(label, events, "partition_data_plane", [
            ("data_plane_fallback", victim, None), ("data_plane_dialed", victim, None)]),
        "control_torn_between_fallback_and_redial": torn,
        "partitioned_shard": ps,
        "pulls_from_partitioned_shard_after": sum(
            1 for t, drawn, _ in pulls if t > t_ps and ps in drawn),
        "shard_epochs": [s.epoch for s in tier.shard_set.shards],
        "restart_events": restarted, "reap_events": reaped,
        "kill_sampler_conn": _recovery(label, events, "kill_sampler_conn", [
            ("actor_reconnect", next(
                e["dropped"] for e in events if e.get("fault") == "kill_sampler_conn"),
             None)]),
        "env_steps_logged": steps,
    }}
    d = rec["direct"]
    if d["dialed_actors"] != list(range(FLEET_ACTORS)):
        raise AssertionError(f"{label}: data_plane_dialed for {d['dialed_actors']}")
    if not up or d["forward_bytes_while_up"] != 0:
        raise AssertionError(f"{label}: the learner forwarded bytes while every data "
                             f"leg was up, or no sample there: {up[:5]}")
    if not d["forward_bytes_final"]:
        raise AssertionError(f"{label}: the partitioned batch was not forwarded")
    if torn:
        raise AssertionError(f"{label}: the control connection tore across the "
                             f"fallback (accounting at risk): {torn}")
    if restarted or d["shard_epochs"] != [1] * SAMPLER_SHARDS:
        raise AssertionError(f"{label}: partition_shard was not survived under the "
                             f"same epoch: {restarted} epochs {d['shard_epochs']}")
    if not d["pulls_from_partitioned_shard_after"]:
        raise AssertionError(f"{label}: no pull from shard {ps} after the partition")
    if reaped:
        raise AssertionError(f"{label}: reaps under the stalls: {reaped}")
    if steps != sorted(steps) or not steps or steps[-1] <= 0:
        raise AssertionError(f"{label}: env steps went down: {steps}")
    return rec


def _sampler_card_vs_cpu(torch, dev, n_batches=64, phases=3):
    """Pulled batches at ``--learner-steps 4`` learned on the card and on the
    CPU from the same params: pendulum_r2d2 width, the batches recorded from
    the port's actor in a thread on the CPU (seed 0) through the f32 wire
    codec into a 2-shard loopback, pulled with seed 0.  Then device-busy
    time of whole pull-learn phases on the card."""
    import dataclasses
    import threading

    import numpy as np

    from r2d2dpg_torch.fleet import FleetActor, FleetConfig, SamplerLearner, wire

    k = SAMPLER_CARD_VS_CPU_K
    config = _config("pendulum_r2d2", "--learner-steps", str(k))
    recorded = []

    def record():
        actor = FleetActor(config, actor_id=0, num_actors=1, address="unused:0",
                           seed=0, device="cpu")
        packer, unpacker = wire.TreePacker(wire.WireConfig()), wire.TreeUnpacker()
        while len(recorded) < n_batches:
            staged = actor.host_batch()
            if staged is not None:
                frame = b"".join(packer.pack({"phase": actor._phase, "staged": staged}))
                recorded.append(unpacker.unpack(frame)["staged"])

    th = threading.Thread(target=record, name="chip-smoke-thread-actor")
    th.start()
    th.join()

    def filled(d, cfg):
        learner = SamplerLearner(cfg.build(d), FleetConfig(num_actors=2),
                                 num_shards=SAMPLER_SHARDS)
        for i, b in enumerate(recorded):
            learner.shards.add(learner.shards.route(i % 2), {"staged": b, "actor_id": i % 2})
        return learner

    src = filled("cpu", config)
    rng = np.random.default_rng(0)
    n = k * config.trainer.batch_size
    pulls = []
    for _ in range(phases):
        seq, probs, handles, occ = src._pull_phase_batches(n, rng)
        pulls.append((seq, probs, occ))
    out, secs = {}, {}
    for d in ("cpu", dev):
        t0 = time.perf_counter()
        learner = SamplerLearner(config.build(d), FleetConfig(num_actors=1),
                                 num_shards=SAMPLER_SHARDS)
        train = learner.trainer.agent.init(torch.Generator().manual_seed(0), d)
        draws = _HostDraws(7, d)
        prios = []
        for seq, probs, occ in pulls:
            seqs, pr = learner._place(seq, probs)
            train, p, _ = learner._learn(train, seqs, pr, occ, draws)
            prios.append(p.cpu())
        out[str(d)] = (train, prios)
        secs[str(d)] = time.perf_counter() - t0
    (tc_, pc), (tg, pg) = out["cpu"], out[str(dev)]

    def rel(a, b):
        return (a - b.cpu()).abs().max().item() / max(a.abs().max().item(), 1e-12)

    errs = {}
    for part in ("actor_params", "critic_params", "target_actor_params",
                 "target_critic_params"):
        a, b = getattr(tc_, part), getattr(tg, part)
        errs[part] = max(rel(a[key], b[key]) for key in a)
    prio_err = max(rel(a, b) for a, b in zip(pc, pg))
    rec = {"learner_steps": k, "phases": phases, "batches": n_batches,
           "steps": [tc_.step, tg.step], "max_param_err_rel": errs,
           "max_priority_err_rel": prio_err, "cpu_seconds": secs["cpu"],
           "card_seconds": secs[str(dev)], "rtol_of_largest": SAMPLER_CARD_VS_CPU_RTOL}
    ok = (tc_.step == tg.step == phases * k
          and max(errs.values()) <= SAMPLER_CARD_VS_CPU_RTOL
          and prio_err <= SAMPLER_CARD_VS_CPU_RTOL)

    # Device-busy time of one whole pull-learn phase at K = 1 on the card:
    # pull from the loopback shards, one copy in, one learner step, one
    # copy out, PRIO write-back.
    one = dataclasses.replace(config, trainer=dataclasses.replace(
        config.trainer, learner_steps=1))
    learner = filled(dev, one)
    state = {"train": learner.trainer.agent.init(torch.Generator().manual_seed(0), dev)}
    draws, prng = _HostDraws(8, dev), np.random.default_rng(1)
    b = one.trainer.batch_size

    def one_phase():
        seq, probs, handles, occ = learner._pull_phase_batches(b, prng)
        seqs, pr = learner._place(seq, probs)
        state["train"], p, _ = learner._learn(state["train"], seqs, pr, occ, draws)
        learner._write_back(handles, p.cpu().numpy())

    for _ in range(3):
        one_phase()
    torch.cuda.synchronize()
    n_timed = 20
    t1 = time.perf_counter()
    for _ in range(n_timed):
        one_phase()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t1) / n_timed * 1e3
    device_ms, top, events = _device_profile(one_phase, 3)
    rec.update(pull_learn_phase_wall_ms=wall_ms,
               device_busy_ms_per_pull_learn_phase=device_ms,
               device_events_per_pull_learn_phase=events,
               device_idle_share=None if device_ms is None else 1 - device_ms / wall_ms,
               top_device_ms_per_pull_learn_phase=top)
    print(json.dumps({"sampler_card_vs_cpu": rec}), flush=True)
    if not ok:
        raise AssertionError(f"sampler pull-learn card vs CPU: {rec}")


def _sampler_phase(torch, dev):
    """In-network sampling: the loopback leg, the standalone-tier leg with
    one shard process killed by ``kill_shard``, the direct data plane under
    its chaos drills, then the pull-learn step card vs CPU."""
    launches = _sampler_leg(torch, dev, "sampler_loopback", ())
    launches.update(_sampler_leg(torch, dev, "sampler_shard_procs", SAMPLER_KILL_FLAGS,
                                 SAMPLER_PROCS_TRAIN_PHASES))
    launches.update(_sampler_leg(torch, dev, "direct_chaos", DIRECT_CHAOS_FLAGS,
                                 DIRECT_CHAOS_PHASES))
    _sampler_card_vs_cpu(torch, dev)
    return launches


HYBRID_TRAIN_PHASES = 10  # train phases of each hybrid1 schedule
HYBRID_TURN_PHASES = 3  # train phases of each turn of (b)'s like-for-like timing
HYBRID_STAND_IN_SEED = 0
HYBRID_BACKEND = "nccl"  # the process group of (a)


def _hybrid_config(overlap):
    """walker_r2d2 at its published width on the host stand-in env."""
    import dataclasses

    from r2d2dpg_torch.configs import WALKER_R2D2
    from r2d2dpg_torch.testing import stand_in_factory

    return dataclasses.replace(
        WALKER_R2D2, env_factory=stand_in_factory(HYBRID_STAND_IN_SEED),
        trainer=dataclasses.replace(WALKER_R2D2.trainer, overlap_learner=overlap))


def _filled(trainer):
    """A fresh state through the warm-up and replay-fill phases."""
    state = trainer.init()
    for _ in range(trainer.window_fill_phases):
        state = trainer.collect_phase(state)
    for _ in range(trainer.replay_fill_phases):
        state = trainer.fill_phase(state)
    return state


def _finite(torch, label, tensors):
    bad = [k for k, x in tensors.items() if not bool(torch.isfinite(x.float()).all())]
    if bad:
        raise AssertionError(f"{label}: non-finite {bad}")


def _hybrid_schedule(torch, label, trainer, state, run):
    """``run(state) -> (state, metrics list)`` over ``HYBRID_TRAIN_PHASES``
    train phases with the launch count set to 0 just before and read just
    after; holds the counters, the host-step count and finite values."""
    from r2d2dpg_torch import kernels

    cfg = trainer.global_config
    hist = trainer._obs_host_step
    hist.reset()
    step0, phase0 = state.train.step, state.phase_idx
    torch.cuda.synchronize()
    for k in kernels.ALL_KERNELS:
        k.launches = 0
    lstm0 = _lstm_mark()
    t0 = time.perf_counter()
    state, metrics = run(state)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / HYBRID_TRAIN_PHASES * 1e3
    launches = kernels.PRIORITY_SCATTER.launches
    lstm = _lstm_check(label, *_lstm_since(lstm0), True)  # walker_r2d2's nets
    count, _, p50, p99 = hist.snapshot()
    n = HYBRID_TRAIN_PHASES
    problems = []
    if launches != n * cfg.learner_steps:
        problems.append(f"scatter launches {launches}, expected {n * cfg.learner_steps}")
    if state.train.step - step0 != n * cfg.learner_steps:
        problems.append(f"learner steps {state.train.step - step0}")
    if state.phase_idx - phase0 != n or (
            state.env_steps != state.phase_idx * cfg.stride * cfg.num_envs):
        problems.append(f"phases {state.phase_idx - phase0}, env steps {state.env_steps}")
    if count != n * cfg.stride:
        problems.append(f"host steps {count}, expected {n * cfg.stride}")
    _finite(torch, label, {**{f"metric {k}": v for m in metrics for k, v in m.items()},
                           "priority": state.arena.priority,
                           **{f"param {k}": v for k, v in state.train.actor_params.items()}})
    if problems:
        raise AssertionError(f"{label}: {problems}")
    rec = {"train_phases": n, "wall_ms_per_train_phase": wall_ms,
           "host_step_ms": [p50 * 1e3, p99 * 1e3], "scatter_launches": launches,
           "lstm_seq_launches": lstm,
           "learner_steps": state.train.step, "env_steps": state.env_steps}
    return state, rec


def _device_share(rec, device_ms):
    rec.update(device_busy_ms_per_train_phase=device_ms,
               device_idle_share=None if device_ms is None
               else 1 - device_ms / rec["wall_ms_per_train_phase"])


def _hybrid1_leg(torch, dev, label="hybrid1"):
    """``HostSPMDTrainer`` at walker_r2d2's published width (64 envs,
    stride 20, 4 learner steps a phase, batch 64, hidden 256, seq 43,
    capacity 100k, ``min_replay`` 2,000) on the host stand-in env
    (``r2d2dpg_torch/testing.py::HostStandInEnv``: walker-walk's spec,
    numpy dynamics, no physics), through its three schedules:

    (a) ``build_spmd`` on a process group of one over NCCL, overlap off:
        warm-up, fill, 10 train phases; params and priorities bitwise the
        plain ``Trainer``'s on the same stand-in and seed;
    (b) ``build("cuda")`` with ``overlap_learner``: the trainer on a mesh of
        one, 10 train phases; every substep samples the arena as of the
        previous emit;
    (c) ``PipelineExecutor`` over (b)'s trainer with overlap off, 10 phases;
    (d) the pipeline over ``build_spmd`` on a process group of one, twice
        from one state (``_hybrid1_pipelined_mesh``).

    Each: one scatter launch per learner step, ``train.step`` 4 per phase,
    ``env_steps`` stride x 64 per phase, stride host steps per phase,
    finite metrics; wall and device-busy ms per train phase, the idle
    share and the host-step p50/p99; (c)'s and (d)'s ``overlap_fraction``
    and param versions."""
    import dataclasses

    from r2d2dpg_torch.parallel import HostSPMDTrainer, make_mesh
    from r2d2dpg_torch.training.pipeline import PipelineConfig, PipelineExecutor
    from r2d2dpg_torch.training.trainer import Trainer
    from r2d2dpg_torch.tree import tree_leaves

    n = HYBRID_TRAIN_PHASES
    launches, out = {}, {}

    def locked(trainer):
        def run(state):
            metrics = []
            for _ in range(n):
                state, m = trainer.train_phase(state)
                metrics.append(m)
            return state, metrics
        return run

    def profile_phase(trainer, box):
        def one():
            box["state"], _ = trainer.train_phase(box["state"])
        return _device_profile(one, 1)[0]

    # (a) sequential, over a process group of one, beside the plain Trainer.
    t_leg = time.perf_counter()
    with _group_of_one():
        seq = _hybrid_config(False).build_spmd(make_mesh(1, dev), dev)
        if not isinstance(seq, HostSPMDTrainer) or torch.distributed.get_backend() != HYBRID_BACKEND:
            raise AssertionError(f"{label}: {type(seq).__name__} on "
                                 f"{torch.distributed.get_backend()}")
        state = _filled(seq)
        # (d) starts from this filled state too (and the stand-in's host state).
        start = (_clone_state(torch, state), _host_state(seq.env))
        state, rec = _hybrid_schedule(torch, f"{label}_seq", seq, state, locked(seq))
        plain = _hybrid_config(False).build(dev)
        if type(plain) is not Trainer:
            raise AssertionError(f"{label}: plain build gave {type(plain).__name__}")
        pstate = _filled(plain)
        for _ in range(n):
            pstate, _ = plain.train_phase(pstate)
        torch.cuda.synchronize()
        pairs = list(zip(tree_leaves(state.train), tree_leaves(pstate.train), strict=True))
        rec["params_bitwise_plain"] = all(torch.equal(a, b) for a, b in pairs)
        rec["priorities_bitwise_plain"] = torch.equal(state.arena.priority,
                                                      pstate.arena.priority)
        del plain, pstate
        box = {"state": state}
        _device_share(rec, profile_phase(seq, box))
        launches[f"{label}_seq"] = rec["scatter_launches"]
        out["seq"] = rec
        del seq, state, box
    torch.cuda.empty_cache()
    if not (out["seq"]["params_bitwise_plain"] and out["seq"]["priorities_bitwise_plain"]):
        raise AssertionError(f"{label}: (a) not bitwise the plain Trainer: {out['seq']}")

    # (b) overlap on a mesh of one, and (c) the pipeline over the same trainer.
    with _group_of_one():
        ov = _hybrid_config(True).build(dev)
        if not isinstance(ov, HostSPMDTrainer) or ov.mesh.size != 1:
            raise AssertionError(f"{label}: overlap build gave {type(ov).__name__}")
        state = _filled(ov)
        added = []  # the arena's total_added at each train phase's start
        seen = []  # (that, the total_added each substep sampled)
        plain_learn_step = ov._learn_step

        def spy(train, arena, draws):
            seen.append((added[-1], arena.total_added))
            return plain_learn_step(train, arena, draws)


        def overlap_run(state):
            metrics = []
            for _ in range(n):
                added.append(state.arena.total_added)
                state, m = ov.train_phase(state)
                metrics.append(m)
            return state, metrics

        ov._learn_step = spy
        try:
            state, rec = _hybrid_schedule(torch, f"{label}_overlap", ov, state, overlap_run)
        finally:
            del ov._learn_step
        lagged = [start == sampled for start, sampled in seen]
        rec["substeps"] = len(seen)
        rec["substeps_on_previous_emit"] = sum(lagged)
        if len(seen) != n * ov.config.learner_steps or not all(lagged):
            raise AssertionError(f"{label}: substeps sampled {seen}, phases added {added}")
        box = {"state": state}
        _device_share(rec, profile_phase(ov, box))
        state = box["state"]
        launches[f"{label}_overlap"] = rec["scatter_launches"]
        # Like for like: the same trainer and state, overlap off and on in
        # turns (off, on, on, off), so both see the same host.
        turns = {False: 0.0, True: 0.0}
        for flag in (False, True, True, False):
            ov.config = dataclasses.replace(ov.config, overlap_learner=flag)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HYBRID_TURN_PHASES):
                state, _ = ov.train_phase(state)
            torch.cuda.synchronize()
            turns[flag] += time.perf_counter() - t0
        rec["turns_ms_per_phase"] = {
            "sequential": turns[False] / (2 * HYBRID_TURN_PHASES) * 1e3,
            "overlap": turns[True] / (2 * HYBRID_TURN_PHASES) * 1e3}
        rec["turns_overlap_over_sequential"] = turns[True] / turns[False]
        out["overlap"] = rec

        ex = PipelineExecutor(ov, PipelineConfig(enabled=True, queue_depth=2))
        logged = []

        def pipelined(state):
            state = ex.run_train_phases(state, n, log_every=n, log_fn=logged.append)
            return state, []

        state, rec = _hybrid_schedule(torch, f"{label}_pipelined", ov, state, pipelined)
        _check_versions(f"{label}_pipelined", ex, n, 2)
        stats = ex.stats()
        numbers = [float(w) for w in logged[-1].split()[3:] if w[:1] in "-0123456789"]
        if not logged or not all(math.isfinite(x) for x in numbers):
            raise AssertionError(f"{label}: pipelined log {logged}")
        rec.update(overlap_fraction=stats["overlap_fraction"], executor_stats=stats)
        box = {"state": state}

        def two():
            box["state"] = ex.run_train_phases(box["state"], 2)

        device_ms = _device_profile(two, 1)[0]
        _device_share(rec, None if device_ms is None else device_ms / 2)
        launches[f"{label}_pipelined"] = rec["scatter_launches"]
        out["pipelined"] = rec
        del ov, ex, state, box
    torch.cuda.empty_cache()

    # (d) the pipeline over the host-pool trainer on a mesh: --spmd D
    # --pipeline 1's path at D = 1, twice from one state.
    rec, launches[f"{label}_pipelined_mesh"] = _hybrid1_pipelined_mesh(
        torch, dev, label, *start)
    del start
    out["pipelined_mesh"] = rec
    out.update(config="walker_r2d2", env="HostStandInEnv", seconds=time.perf_counter() - t_leg,
               overlap_over_seq=(out["overlap"]["wall_ms_per_train_phase"]
                                 / out["seq"]["wall_ms_per_train_phase"]),
               pipelined_over_seq=(out["pipelined"]["wall_ms_per_train_phase"]
                                   / out["seq"]["wall_ms_per_train_phase"]),
               pipelined_mesh_over_seq=(out["pipelined_mesh"]["wall_ms_per_train_phase"]
                                        / out["seq"]["wall_ms_per_train_phase"]))
    print(json.dumps({label: out}), flush=True)
    return launches


HYBRID_MESH_DEPTH = 2  # (d)'s staging-queue depth


def _check_versions(label, ex, n, depth):
    """Each of the section's ``n`` collect phases acted with the params
    after ``max(0, k - depth - 1)`` drains, and no refresh waited."""
    want = [max(0, k - depth - 1) for k in range(n)]
    if ex.param_versions != want or ex.version_waits:
        raise AssertionError(f"{label}: param versions {ex.param_versions} "
                             f"(waits {ex.version_waits}), expected {want}")


def _clone_state(torch, node):
    """``node`` with every tensor cloned and every ``Draws`` copied at its
    generator's state: a twin run's own copy of a trainer state."""
    import dataclasses

    from r2d2dpg_torch.training.draws import Draws

    if isinstance(node, torch.Tensor):
        return node.clone()
    if isinstance(node, Draws):
        twin = Draws(node.seed, node.device)
        twin.generator.set_state(node.generator.get_state())
        return twin
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return dataclasses.replace(node, **{
            f.name: _clone_state(torch, getattr(node, f.name))
            for f in dataclasses.fields(node)})
    if isinstance(node, dict):
        return {k: _clone_state(torch, v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_clone_state(torch, v) for v in node)
    return node


def _host_state(env):
    """A copy of ``HostStandInEnv``'s host-side state (obs, step counts,
    the lanes' start-state generators)."""
    return copy.deepcopy({k: env.__dict__[k] for k in ("_obs", "_t", "_rngs")})


def _hybrid1_pipelined_mesh(torch, dev, label, start, host):
    """(d) ``PipelineExecutor(queue_depth=2)`` over ``HostSPMDTrainer`` built
    with ``build_spmd`` on a process group of one over NCCL (the path of
    ``--spmd D --pipeline 1`` with a DM-Control config, at D = 1), walker
    width on the stand-in: 10 train phases twice from ``start``, (a)'s
    state after warm-up and fill (same seed), with the stand-in's host
    state ``host`` restored each time.
    Each run: one scatter launch per learner step, ``train.step`` 4 and
    ``env_steps`` 20 x 64 a phase, every metric finite, phase k acting
    with the params after ``max(0, k - 3)`` drains, no refresh waiting,
    no ``torch.distributed`` collective on the collector thread (and some
    on the learner's); the two runs' params and priorities bitwise equal.
    Returns the record and the launches of both runs."""
    from r2d2dpg_torch.parallel import HostSPMDTrainer, make_mesh
    from r2d2dpg_torch.testing import count_collectives
    from r2d2dpg_torch.training.pipeline import PipelineConfig, PipelineExecutor
    from r2d2dpg_torch.tree import tree_leaves

    n, depth = HYBRID_TRAIN_PHASES, HYBRID_MESH_DEPTH
    name = f"{label}_pipelined_mesh"
    with _group_of_one():
        t = _hybrid_config(False).build_spmd(make_mesh(1, dev), dev)
        if (not isinstance(t, HostSPMDTrainer)
                or torch.distributed.get_backend() != HYBRID_BACKEND):
            raise AssertionError(f"{name}: {type(t).__name__} on "
                                 f"{torch.distributed.get_backend()}")
        ex = PipelineExecutor(t, PipelineConfig(enabled=True, queue_depth=depth))
        calls = {}

        def pipelined(state):
            logged = []
            with count_collectives() as counted:
                state = ex.run(state.phase_idx + n, state=state, log_every=n,
                               metrics_fn=lambda phase, scalars: logged.append(scalars))
            calls.update(counted)
            return state, [{k: torch.tensor(v) for k, v in sc.items()} for sc in logged]

        runs, ends = [], []
        for twin in range(2):
            t.env.__dict__.update(copy.deepcopy(host))
            calls.clear()
            state, rec = _hybrid_schedule(torch, f"{name}_{twin}", t,
                                          _clone_state(torch, start), pipelined)
            _check_versions(f"{name}_{twin}", ex, n, depth)
            if calls.get("pipeline-collector", 0) or not calls.get("MainThread", 0):
                raise AssertionError(f"{name}_{twin}: collectives by thread {calls}")
            stats = ex.stats()
            rec.update(param_versions=list(ex.param_versions),
                       version_waits=ex.version_waits,
                       collectives_by_thread=dict(calls),
                       overlap_fraction=stats["overlap_fraction"],
                       learner_wait_ms=[stats["learner_wait_p50_ms"],
                                        stats["learner_wait_p99_ms"]],
                       collect_wait_ms=[stats["collect_wait_p50_ms"],
                                        stats["collect_wait_p99_ms"]],
                       executor_stats=stats)
            runs.append(rec)
            ends.append(state)
        pairs = list(zip(tree_leaves(ends[0].train), tree_leaves(ends[1].train), strict=True))
        bitwise = (all(torch.equal(a, b) for a, b in pairs)
                   and torch.equal(ends[0].arena.priority, ends[1].arena.priority))
        if not bitwise:
            diff = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
            raise AssertionError(f"{name}: the twin runs differ (params by {diff})")
        box = {"state": ends[1]}

        def two():
            box["state"] = ex.run(box["state"].phase_idx + 2, state=box["state"],
                                  log_every=0)

        device_ms = _device_profile(two, 1)[0]
        rec = dict(runs[1], twins_bitwise=bitwise, twin_wall_ms_per_train_phase=[
            r["wall_ms_per_train_phase"] for r in runs], card=_card_line()[0])
        _device_share(rec, None if device_ms is None else device_ms / 2)
        del t, ex, ends, box
    torch.cuda.empty_cache()
    print(json.dumps({name: rec}), flush=True)
    return rec, sum(r["scatter_launches"] for r in runs)


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
    lstm_gap = timed("lstm_seq", _lstm_seq_phase, torch, dev)
    timed("cuda_graph", _graph_phase, torch, dev)
    launches = timed("learner_legs", _learner_phase, torch, dev)
    timed("cuda_vs_cpu", _cuda_vs_cpu_phase, torch, dev)
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    plain = {}

    def after_plain_run(state):
        # The mesh CLI legs end bitwise on this run's params and priorities.
        plain.update(train=copy.deepcopy(state.train),
                     priority=state.arena.priority.clone())
        return timed("checkpoint_serve_cli_eval", _checkpoint_phase,
                     torch, dev, ckdir, state)

    try:
        launches.update(timed(
            "trainer", _trainer_phase, torch, dev, "pendulum_r2d2_trainer",
            ("--checkpoint-dir", ckdir, "--checkpoint-every", "5"), after_plain_run))
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    phase_seconds["trainer"] -= phase_seconds["checkpoint_serve_cli_eval"]
    launches.update(timed(
        "trainer_td3_bf16", _trainer_phase,
        torch, dev, "pendulum_r2d2_td3_bf16_trainer", (*TD3_FLAGS, *BF16_FLAGS)))
    # Before the serving and fleet phases: their gauges stay on the process
    # registry, and a stopped fleet's would degrade this run's /health.
    telemetry_launches, telemetry = timed("telemetry", _telemetry_phase, torch, dev)
    launches.update(telemetry_launches)
    timed("flop_parity", _flop_parity, torch, dev)
    timed("serving", _serving_phase, torch, dev)
    side_err = timed("side_stream_scatter", _side_stream_scatter, torch, dev)
    timed("pipeline_off_anchor", _pipeline_off_anchor, torch, dev)
    launches.update(timed("pipelined", _pipelined_phase, torch, dev))
    launches.update(timed("fleet", _fleet_phase, torch, dev))
    launches.update(timed("fleet_autoscale", _fleet_autoscale_leg, torch, dev))
    launches.update(timed("sampler", _sampler_phase, torch, dev))
    # The mesh legs come last, so every leg before them runs in the process
    # as it ran before they existed.
    with _group_of_one():
        launches.update(timed("learner_dp1", _learner_dp1_leg, torch, dev))
    launches.update(timed("mesh_cli", _mesh_cli_legs, torch, dev, plain))
    launches.update(timed("fleet_dp1", _fleet_dp1_leg, torch, dev))
    launches.update(timed("sampler_dp1", _sampler_dp1_leg, torch, dev))
    launches.update(timed("mesh_lifecycle1", _mesh_lifecycle1_leg, torch, dev))
    launches.update(timed("hybrid1", _hybrid1_leg, torch, dev))
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
        "train_window_cupti_us": telemetry["window_scatter_mean_cupti_us"],
        "train_window_kernels": telemetry["window_scatter_kernels"],
        "card": card_name,
        "power_limit": power_limit,
    }, {
        "name": "lstm_seq",
        "route": "cuda",
        "source": "r2d2dpg_torch/csrc/lstm_seq.cu",
        "replaces": None,
        "launches": sum(LSTM_LAUNCHES.values()),
        "launches_by_path": LSTM_LAUNCHES,
        "max_gap": lstm_gap,
        "card": card_name,
        "power_limit": power_limit,
    }]}
    print(json.dumps(summary), flush=True)
    if LSTM_MISSES:
        raise AssertionError(f"lstm_seq launches off the counters: {LSTM_MISSES}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
