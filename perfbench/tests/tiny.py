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


def cell(kind: str, conf: dict, limits=None, **traffic) -> harness.Cell:
    base = json.loads((harness.HERE / "traffic" / f"{kind}.json").read_text())
    base.update(traffic)
    manifest = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    name = {"learn": "walker_r2d2.learn", "train": "walker_r2d2.train",
            "serve": "walker_r2d2.serve"}[kind]
    real = harness.find_cell(name, manifest)
    return harness.Cell(workload=dict(real.workload), config=conf, traffic=base,
                        limits=limits or real.limits, end_to_end=real.end_to_end,
                        per_layer=real.per_layer)


def run(c: harness.Cell, seed: int = 3, seconds: float = 0.2, trace=False):
    r = harness.Run(cell=c, seed=seed, seconds=seconds, trace=trace,
                    device=torch.device("cpu"), started=time.perf_counter())
    w = harness.run_driver(r)
    return r, w, harness.result(r, w)
