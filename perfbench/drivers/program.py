"""The system under test, built from a configuration file, and the
benchmark's inputs handed to it in the program's own types.

The only module of the harness, with ``standin_env.py``, that imports
``r2d2dpg_torch``; the drivers reach the program through it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from r2d2dpg_torch.agents.ddpg import TrainState, adam_init
from r2d2dpg_torch.configs import ExperimentConfig, get_config
from r2d2dpg_torch.device import resolve_device
from r2d2dpg_torch.replay.arena import ArenaState, SequenceBatch

from perfbench.drivers.standin_env import StandInEnv


def device(dev) -> torch.device:
    """``dev`` as the program's entry points resolve it (which also pins
    float32 matmuls and convolutions to full precision, as they run)."""
    return resolve_device(dev)


def experiment(conf: Dict, env_seed: int) -> ExperimentConfig:
    """The program's config that ``conf`` names, its env replaced by the
    benchmark's stand-in; raises where its numbers differ from ``conf``, or
    where the program's config lacks a key of the file: every key of
    ``nets`` is the config's attribute of that name (but ``core``, which
    names the benchmark's model entry), every key of ``agent`` and
    ``trainer`` that of its agent and trainer config."""
    cfg = get_config(conf["program_config"])
    want = {}
    for group, obj in (("nets", cfg), ("agent", cfg.agent), ("trainer", cfg.trainer)):
        for k, v in conf[group].items():
            if group == "nets" and k == "core":
                continue
            if not hasattr(obj, k):
                raise ValueError(f"{conf['name']}: the program's config has no {group}.{k}")
            want[f"{group}.{k}"] = (getattr(obj, k), v)
    bad = {k: got for k, (got, v) in want.items() if got != v}
    if bad:
        raise ValueError(f"{conf['name']}: the program's config differs from the file: {bad}")
    env = conf["env"]
    return dataclasses.replace(cfg, env_factory=lambda device: StandInEnv(
        env_seed, device, obs_shape=tuple(env["obs_shape"]), obs_dtype=env["obs_dtype"],
        action_dim=env["action_dim"], episode_length=env["episode_length"]))


def dp_learner(cfg: ExperimentConfig, world: int, dev: torch.device):
    """The data-parallel learner a user starts with ``--learner-dp <world>``
    (``DPLearnerTrainer`` over this rank's block of the arena), on the mesh
    of the process group this process has joined."""
    from r2d2dpg_torch.parallel import make_mesh

    return cfg.build_dp_learner(make_mesh(world, dev), collect_local=False)


def train_state(agent, weights: Dict[str, Dict[str, torch.Tensor]]) -> TrainState:
    """A fresh learner state on the benchmark's weights (targets as copies,
    zero Adam moments); the keys and shapes must be the program's."""
    for net, module in (("actor", agent.actor), ("critic", agent.critic)):
        have = {k: tuple(v.shape) for k, v in module.named_parameters()}
        want = {k: tuple(v.shape) for k, v in weights[net].items()}
        if have != want:
            raise ValueError(f"{net}: program params {have} != benchmark's {want}")
    copy = lambda p: {k: v.clone() for k, v in p.items()}  # noqa: E731
    actor, critic = copy(weights["actor"]), copy(weights["critic"])
    return TrainState(actor_params=actor, critic_params=critic,
                      target_actor_params=copy(actor), target_critic_params=copy(critic),
                      actor_opt_state=adam_init(actor), critic_opt_state=adam_init(critic),
                      step=0)


def arena_leaves(state: ArenaState) -> Dict:
    """The program arena's buffers in the layout of ``inputs.fill_arena``."""
    d = state.data
    return {"obs": d.obs, "action": d.action, "reward": d.reward, "discount": d.discount,
            "reset": d.reset, "carry_actor": tuple(d.carries["actor"]),
            "carry_critic": tuple(d.carries["critic"])}


def sequence_batch(leaves: Dict) -> SequenceBatch:
    return SequenceBatch(obs=leaves["obs"], action=leaves["action"], reward=leaves["reward"],
                         discount=leaves["discount"], reset=leaves["reset"],
                         carries={"actor": leaves["carry_actor"],
                                  "critic": leaves["carry_critic"]})


def params_of(state: TrainState) -> Dict[str, Dict[str, torch.Tensor]]:
    return {"actor": state.actor_params, "critic": state.critic_params,
            "target_actor": state.target_actor_params,
            "target_critic": state.target_critic_params}


def moments_of(state: TrainState) -> Dict[str, Dict[str, torch.Tensor]]:
    return {"actor": state.actor_opt_state.mu, "critic": state.critic_opt_state.mu}
