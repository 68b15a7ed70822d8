"""The train loop a user starts (``python -m r2d2dpg_torch.train``), driven
through the program's public phases on the benchmark's stand-in env.

Set-up builds the plain ``Trainer`` from the configuration
(``ExperimentConfig.build``), hands it the benchmark's draws and weights,
and runs its own schedule: the window-fill and replay-fill phases, then
the first ``train_phase`` calls, which the reference follows (the
collected actions, the added sequences, the learner steps).  The window
runs ``Trainer.train_phase`` back to back until ``--seconds`` pass.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import torch

from perfbench import compare, inputs, models, trace
from perfbench.drivers import program
from perfbench.harness import Run, Window, peak_bytes, sync
from perfbench.reference import runs as reference


def run(run: Run) -> Window:
    cell, dev = run.cell, program.device(run.device)
    conf, traffic = cell.config, cell.traffic
    tr, model = conf["trainer"], models.entry(conf)
    env_seed = inputs.subseed(run.seed, "env")
    run.mark("imports")
    trainer = program.experiment(conf, env_seed).build(dev)
    draws = inputs.Draws(run.seed, "trainer", dev)
    state = trainer.init(draws)
    weights = inputs.make_weights(model.shapes(conf), run.seed, dev)
    train = program.train_state(trainer.agent, weights)
    state = dataclasses.replace(
        state, train=train,
        behavior_params={k: v.clone() for k, v in train.actor_params.items()})
    warm, fill = trainer.window_fill_phases, trainer.replay_fill_phases
    run.mark("program and inputs")
    for _ in range(warm):
        state = trainer.collect_phase(state)
    for _ in range(fill):
        state = trainer.fill_phase(state)
    run.mark("fill phases")

    finite = []
    seen = []

    def phase():
        nonlocal state
        with run.spans("train_phase"):
            state, m = trainer.train_phase(state)
        finite.append(torch.isfinite(torch.stack(list(m.values()))).all())
        return m

    # The first train phases, which the reference follows; the sampled
    # indices are read off the trainer's sample calls.
    sample = trainer._sample
    indices = []

    def recorded(arena, d):
        res = sample(arena, d)
        indices.append(res.indices.clone())
        return res

    trainer._sample = recorded
    losses, moment = [], None
    for _ in range(traffic["check_units"]):
        m = phase()
        losses.append(torch.stack([m["critic_loss"], m["actor_loss"]]))
        if moment is None:
            moment = {k: compare.norms(v) for k, v in program.moments_of(state.train).items()}
            priority = state.arena.priority.clone()
    del trainer._sample
    added = (fill + traffic["check_units"]) * tr["num_envs"]
    prog = {"losses": [tuple(x) for x in torch.stack(losses).tolist()], "moment": moment,
            "change": compare.change_norms(program.params_of(state.train), weights),
            "priority": priority}
    run.mark("checked phases")
    for _ in range(traffic["warmup_units"] - traffic["check_units"]):
        phase()

    sync(dev)
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < run.seconds:
        phase()
        n += 1
    sync(dev)
    window_s = time.perf_counter() - t0
    per_phase = tr["stride"] * tr["num_envs"]
    window = Window(
        attempted=n, failed=0, setup_s=t0 - run.started,
        end_to_end={"train_env_steps_per_s": n * per_phase / window_s}, checks={},
        memory_peak_bytes=peak_bytes(dev),
        readings={"units": n, "window_s": window_s, "unit_flops": model.train_unit(conf),
                  "dtype": conf["nets"]["compute_dtype"]})
    if run.trace:
        def traced():
            trainer._sample = lambda arena, d: seen.append(sample(arena, d)) or seen[-1]
            phase()
            del trainer._sample

        window.trace = trace.profile(traced, traffic["trace_units"])
        b = tr["batch_size"]
        window.readings["scatter_bytes"] = [12 * b + 4 * int(torch.unique(r.indices).numel())
                                            for r in seen]
        window.breakdown = trace.breakdown(
            window.trace, trace.profile(phase, traffic["breakdown_units"], host=True))
    params_ok = all(bool(torch.isfinite(v).all())
                    for tree in program.params_of(state.train).values() for v in tree.values())
    window.failed = (sum(not bool(f) for f in finite[traffic["warmup_units"]:][:n])
                     + int(not params_ok or not bool(torch.isfinite(state.arena.priority).all())))

    leaves = program.arena_leaves(state.arena)
    prog["seqs"] = [x[:added].clone() for x in reference.sequence_leaves(leaves)]
    del trainer, state, train, draws, finite, seen, leaves, sample
    gc.collect()
    torch.cuda.empty_cache()
    ref = model.train(conf, run.seed, env_seed, dev, indices, traffic["check_units"])
    window.checks = compare.training_checks(prog, ref)
    window.readings["wide"] = compare.wide_checks(prog, ref)
    return window
