"""The learn loop on several chips: the data-parallel learner a user starts
with ``--learner-dp D``, learner updates back to back over a full arena
split into capacity blocks.

Rank 0 runs here, in the harness's process; ``perfbench/ranks.py`` starts
ranks ``1 .. D-1`` and each runs ``follow``.  Every rank runs ``_session``:
it joins the process group, builds ``ExperimentConfig.build_dp_learner``
(``DPLearnerTrainer``: ``CapacityBlockArena`` and the mesh-bound
``R2D2DPG``), draws the whole arena from the seed as the one-chip learn
loop does and keeps its block of it, and takes the benchmark's weights
and the same replicated uniforms.  So every rank draws the indices the
one-chip draw gives, and the one-chip reference on those indices judges
the run.  The updates are ``Trainer._sample`` (the all-gathered block
priorities, the global draw, the reduce-scatter of the rows) and
``Trainer._update_step`` (the gradients' pmean, the all-gathered
priorities through the scatter kernel on the rank's block).

The first ``check_units`` updates are what the reference follows: their
losses averaged over the ranks (``Trainer._pmean``), rank 0's Adam moments
and parameters (replicated) and the whole priority vector after the first
(all-gathered).  The window runs until ``--seconds`` pass on rank 0's
clock; ``learner_steps_per_s`` is the window's global steps over rank 0's
seconds.  Every device reading (the trace, ``busy_s``, the idle share) is
rank 0's; the memory peak is the largest of any rank's, counted from the
moment the rank dropped the whole arena it drew its block from.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import torch

from perfbench import compare, harness, inputs, models, ranks, trace
from perfbench.drivers import program
from perfbench.harness import Run, Window, peak_bytes, sync

FOLLOWER = __name__  # the module each child rank runs ``follow`` of


def run(run: Run) -> Window:
    """Rank 0: start the other ranks, run the session, judge it."""
    world = run.cell.traffic["world"]
    group = ranks.Ranks(run, world, FOLLOWER, lambda reason: harness.fault_exit(run, reason))
    try:
        out = _session(run, group)
        reports = group.reports()
    except BaseException:
        group.abort()
        raise
    group.close()
    return _judge(run, out, reports)


def follow(run: Run, group: ranks.Follower) -> Dict:
    """A child rank: the same session; its report for rank 0."""
    out = _session(run, group)
    return {k: out[k] for k in ("units", "failed", "peak")}


def _session(run: Run, group) -> Dict:
    cell, dev = run.cell, program.device(run.device)
    conf, traffic = cell.config, cell.traffic
    env, tr, model = conf["env"], conf["trainer"], models.entry(conf)
    carries = model.carries(conf)
    run.mark("imports")
    group.join_group(dev)
    run.mark("process group")
    cfg = program.experiment(conf, inputs.subseed(run.seed, "env"))
    trainer = program.dp_learner(cfg, group.world, dev)
    lo, block = trainer.arena.lo, trainer.arena.block
    example = inputs.alloc_arena(1, model.seq_len(conf), env["obs_shape"], env["obs_dtype"],
                                 env["action_dim"], carries, dev)
    arena = trainer.arena.init_state(program.sequence_batch(example))
    _keep_block(arena, lo, block, conf, carries, run.seed, traffic["priority_range"], dev)
    if dev.type == "cuda":  # the peak counts what the rank holds from here on
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    arena.cursor, arena.total_added = 0, tr["capacity"]
    weights = inputs.make_weights(model.shapes(conf), run.seed, dev)
    train = program.train_state(trainer.agent, weights)
    draws = inputs.Draws(run.seed, "learner", dev)
    sync(dev)
    run.mark("program and inputs")
    finite, seen = [], []

    def step():
        nonlocal train, arena
        with run.spans("sample"):
            res = trainer._sample(arena, draws)
        with run.spans("learner_step"):
            train, arena, m = trainer._update_step(
                train, arena, res, trainer._smoothing_normal(res, draws))
        finite.append(torch.isfinite(torch.stack(list(m.values()))).all())
        return res, m

    # The first updates, which the reference follows.
    indices, losses = [], []
    moment = whole_priority = None
    for _ in range(traffic["check_units"]):
        res, m = step()
        both = trainer._pmean({"critic_loss": m["critic_loss"], "actor_loss": m["actor_loss"]})
        indices.append(res.indices.clone())
        losses.append(torch.stack([both["critic_loss"], both["actor_loss"]]))
        if moment is None:
            moment = {k: compare.norms(v) for k, v in program.moments_of(train).items()}
            whole_priority = trainer.arena.mesh.all_gather(arena.priority)
    prog = {"losses": [tuple(x) for x in torch.stack(losses).tolist()], "moment": moment,
            "change": compare.change_norms(program.params_of(train), weights),
            "priority": whole_priority}
    run.mark("checked steps")
    for _ in range(traffic["warmup_units"] - traffic["check_units"]):
        step()

    sync(dev)
    t0 = time.perf_counter()
    n, stop = 0, None
    while True:
        if stop is None:
            stop = group.stop_at(n, t0)
        if stop is not None and n >= stop:
            break
        step()
        n += 1
    sync(dev)
    window_s = time.perf_counter() - t0
    peak = peak_bytes(dev)
    out = {"units": n, "window_s": window_s, "setup_s": t0 - run.started, "peak": peak,
           "prog": prog, "indices": indices, "trace": None, "breakdown": None,
           "scatter_bytes": None}
    if run.trace:
        def traced():
            res, _ = step()
            seen.append(res.indices)

        out["trace"] = trace.profile(traced, traffic["trace_units"])
        own = [i[(i >= lo) & (i < lo + block)] for i in seen]
        out["scatter_bytes"] = [12 * len(i) + 4 * int(torch.unique(o).numel())
                                for i, o in zip(seen, own)]
        if group.primary:
            out["breakdown"] = trace.breakdown(
                out["trace"], trace.profile(step, traffic["breakdown_units"], host=True))
        else:
            for _ in range(traffic["breakdown_units"]):
                step()
        sync(dev)
    bad_steps = sum(not bool(f) for f in finite[traffic["warmup_units"]:][:n])
    out["failed"] = bad_steps + int(not bool(torch.isfinite(arena.priority).all()))
    return out


def _keep_block(arena, lo: int, block: int, conf: Dict, carries, seed: int,
                priority_range, dev: torch.device) -> None:
    """Draw the whole arena from the seed as the one-chip learn loop does and
    copy slots ``lo .. lo + block`` into this rank's ``arena``; the whole
    arena is freed on return."""
    env = conf["env"]
    whole = inputs.alloc_arena(conf["trainer"]["capacity"], models.entry(conf).seq_len(conf),
                               env["obs_shape"], env["obs_dtype"], env["action_dim"], carries,
                               dev)
    priority = torch.zeros(conf["trainer"]["capacity"], device=dev)
    inputs.fill_arena(whole, priority, seed, env["episode_length"], priority_range, carries)
    mine = program.arena_leaves(arena)
    for key, leaf in whole.items():
        for dst, src in zip(mine[key], leaf) if isinstance(leaf, tuple) else [(mine[key], leaf)]:
            dst.copy_(src[lo:lo + block])
    arena.priority.copy_(priority[lo:lo + block])


def _judge(run: Run, out: Dict, reports) -> Window:
    """The result from rank 0's session and the children's reports, then the
    one-chip reference on rank 0's card (every rank's state is freed)."""
    cell, dev = run.cell, program.device(run.device)
    conf, traffic, model = cell.config, cell.traffic, models.entry(cell.config)
    units = out["units"]
    bad = [r for r, rep in enumerate(reports, 1) if rep["units"] != units]
    window = Window(
        attempted=units,
        failed=out["failed"] + sum(rep["failed"] for rep in reports),
        setup_s=out["setup_s"],
        end_to_end={"learner_steps_per_s": units / out["window_s"]},
        checks={},
        memory_peak_bytes=max([out["peak"]] + [rep["peak"] for rep in reports]),
        readings={"units": units, "window_s": out["window_s"],
                  "unit_flops": model.learn_unit(_per_rank(conf, traffic["world"])),
                  "dtype": conf["nets"]["compute_dtype"],
                  "scatter_bytes": out["scatter_bytes"]})
    if run.trace:
        window.trace = dict(out["trace"])
        window.breakdown = out["breakdown"]
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = model.learn(conf, traffic, run.seed, dev, out["indices"])
    window.checks = dict(compare.training_checks(out["prog"], ref), rank_faults=float(len(bad)))
    window.readings["wide"] = compare.wide_checks(out["prog"], ref)
    return window


def _per_rank(conf: Dict, world: int) -> Dict:
    """The configuration at one rank's share of the batch (FLOPs are linear
    in it), for the per-chip share of the peak."""
    trainer = dict(conf["trainer"], batch_size=conf["trainer"]["batch_size"] // world)
    return dict(conf, trainer=trainer)
