"""Cells at toy sizes for the CPU tests, built from the port's own toy
configs (``pendulum_tiny``, and a pixel config registered by the tests)
with the benchmark's stand-in env and traffic."""

from __future__ import annotations

import dataclasses
import json
import time

import torch

from perfbench import harness

AGENT_KEYS = ("burnin", "unroll", "n_step", "gamma", "tau", "eta", "actor_lr", "critic_lr",
              "grad_clip", "use_huber", "twin_critic", "target_policy_sigma")
TRAINER_KEYS = ("num_envs", "stride", "learner_steps", "batch_size", "capacity", "prioritized",
                "priority_alpha", "beta0", "beta_steps", "min_replay", "sigma_max",
                "ladder_alpha", "ladder_kind", "noise", "param_sync_every", "initial_priority")


def config_file(program_config: str, obs_shape=(24,), obs_dtype="float32",
                episode_length=12) -> dict:
    """A configuration file's dict for one of the port's configs."""
    from r2d2dpg_torch.configs import get_config

    cfg = get_config(program_config)
    return {
        "name": program_config, "program_config": program_config,
        "env": {"obs_shape": list(obs_shape), "obs_dtype": obs_dtype, "action_dim": 6,
                "episode_length": episode_length},
        "nets": {"hidden": cfg.hidden, "use_lstm": cfg.use_lstm, "pixels": cfg.pixels,
                 "compute_dtype": cfg.compute_dtype},
        "agent": {k: getattr(cfg.agent, k) for k in AGENT_KEYS},
        "trainer": {k: getattr(cfg.trainer, k) for k in TRAINER_KEYS},
    }


def tiny_pixels():
    """A pixel config at toy widths (36x36 frames, hidden 16) on the port's
    cheetah_pixels recipe."""
    from r2d2dpg_torch.configs import CHEETAH_PIXELS

    return dataclasses.replace(
        CHEETAH_PIXELS, name="perfbench_tiny_pixels", hidden=16,
        agent=dataclasses.replace(CHEETAH_PIXELS.agent, burnin=2, unroll=3, n_step=2),
        trainer=dataclasses.replace(CHEETAH_PIXELS.trainer, num_envs=4, batch_size=4,
                                    capacity=32, min_replay=8))


# Kinds that no cell of the manifest runs yet, with the mix that stands for
# them: the learn loop on several chips, whose cell waits on the program
# (PERF.md, Open questions), on a learn cell's frame.
STAND_IN = {"learn_dp": ("learn_dp4", "learn")}


def cell(kind: str, conf: dict, limits=None, **traffic) -> harness.Cell:
    """The first cell of the manifest whose mix is of ``kind``, on ``conf``,
    its mix's values replaced by ``traffic``'s.  A kind of ``STAND_IN`` takes
    its mix file and the first cell of the other kind's workload, metrics and
    limits (with ``rank_faults`` 0), its chips the mix's ``world``."""
    manifest = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cells = [harness.find_cell(w["name"], manifest) for w in manifest["workloads"]]
    mix, frame_kind = STAND_IN.get(kind, (None, kind))
    real = next(c for c in cells if c.traffic["kind"] == frame_kind)
    workload, base, frame_limits = dict(real.workload), dict(real.traffic), real.limits
    if mix is not None:
        base = harness.load_json(harness.HERE / "traffic" / f"{mix}.json")
        workload["chips"] = base["world"]
        frame_limits = dict(real.limits, rank_faults=0)
    return harness.Cell(workload=workload, config=conf, traffic=dict(base, **traffic),
                        limits=limits or frame_limits, end_to_end=real.end_to_end,
                        per_layer=real.per_layer)


def run(c: harness.Cell, seed: int = 3, seconds: float = 0.2, trace=False):
    r = harness.Run(cell=c, seed=seed, seconds=seconds, trace=trace,
                    device=torch.device("cpu"), started=time.perf_counter())
    w = harness.run_driver(r)
    return r, w, harness.result(r, w)
