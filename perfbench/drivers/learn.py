"""The learn loop: the learner update as the program's ``Trainer`` runs it,
back to back over a full arena.

Set-up fills the program's arena at the configuration's capacity from the
seed, puts the benchmark's weights into a fresh learner state and runs the
first updates through the window's own calls (``Trainer._sample`` on the
benchmark's uniforms, then ``Trainer._update_step``: IS weights with the
annealed beta, ``R2D2DPG.learner_step``, the priority write-back); the
first ``check_units`` of them are what the reference follows.  The window
runs the same calls until ``--seconds`` pass.
"""

from __future__ import annotations

import gc
import time

import torch

from perfbench import compare, inputs, models, trace
from perfbench.drivers import program
from perfbench.harness import Run, Window, peak_bytes, sync


def run(run: Run) -> Window:
    from r2d2dpg_torch.training.trainer import Trainer

    cell, dev = run.cell, program.device(run.device)
    conf, traffic = cell.config, cell.traffic
    env, tr, model = conf["env"], conf["trainer"], models.entry(conf)
    carries = model.carries(conf)
    run.mark("imports")
    cfg = program.experiment(conf, inputs.subseed(run.seed, "env"))
    env_obj = cfg.env_factory(dev)
    agent = cfg.build_agent(env_obj)
    trainer = Trainer(env_obj, agent, cfg.trainer, dev)
    example = inputs.alloc_arena(1, model.seq_len(conf), env["obs_shape"], env["obs_dtype"],
                                 env["action_dim"], carries, dev)
    arena = trainer.arena.init_state(program.sequence_batch(example))
    inputs.fill_arena(program.arena_leaves(arena), arena.priority, run.seed,
                      env["episode_length"], traffic["priority_range"], carries)
    arena.cursor, arena.total_added = 0, tr["capacity"]
    weights = inputs.make_weights(model.shapes(conf), run.seed, dev)
    train = program.train_state(agent, weights)
    draws = inputs.Draws(run.seed, "learner", dev)
    sync(dev)
    run.mark("program and inputs")
    finite = []
    seen = []

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
    moment = None
    for _ in range(traffic["check_units"]):
        res, m = step()
        indices.append(res.indices.clone())
        losses.append(torch.stack([m["critic_loss"], m["actor_loss"]]))
        if moment is None:
            moment = {k: compare.norms(v) for k, v in program.moments_of(train).items()}
            priority = arena.priority.clone()
    prog = {"losses": [tuple(x) for x in torch.stack(losses).tolist()], "moment": moment,
            "change": compare.change_norms(program.params_of(train), weights),
            "priority": priority}
    run.mark("checked steps")
    for _ in range(traffic["warmup_units"] - traffic["check_units"]):
        step()

    sync(dev)
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < run.seconds:
        step()
        n += 1
    sync(dev)
    window_s = time.perf_counter() - t0
    peak = peak_bytes(dev)
    window = Window(
        attempted=n, failed=0, setup_s=t0 - run.started,
        end_to_end={"learner_steps_per_s": n / window_s}, checks={},
        memory_peak_bytes=peak,
        readings={"units": n, "window_s": window_s, "unit_flops": model.learn_unit(conf),
                  "dtype": conf["nets"]["compute_dtype"]})
    if run.trace:
        def traced():
            res, _ = step()
            seen.append(res.indices)

        window.trace = trace.profile(traced, traffic["trace_units"])
        window.readings["scatter_bytes"] = [12 * len(i) + 4 * int(torch.unique(i).numel())
                                            for i in seen]
        window.breakdown = trace.breakdown(
            window.trace, trace.profile(step, traffic["breakdown_units"], host=True))
    bad_steps = sum(not bool(f) for f in finite[traffic["warmup_units"]:][:n])
    window.failed = bad_steps + int(not bool(torch.isfinite(arena.priority).all()))

    del trainer, agent, env_obj, arena, train, draws, res, m, finite, seen
    gc.collect()
    torch.cuda.empty_cache()
    ref = model.learn(conf, traffic, run.seed, dev, indices)
    window.checks = compare.training_checks(prog, ref)
    window.readings["wide"] = compare.wide_checks(prog, ref)
    return window
