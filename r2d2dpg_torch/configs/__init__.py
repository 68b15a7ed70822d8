"""Named experiment configs of the port.

Port of ``r2d2dpg_tpu/configs/__init__.py``, every config with the JAX
constants: ``pendulum_tiny``, ``pendulum_ddpg`` and ``pendulum_r2d2`` train
end to end.  ``walker_r2d2``, ``walker_r2d2_ns5``, ``humanoid_r2d2`` and
``cheetah_pixels`` carry their agent, net and trainer constants, so
``build_agent`` makes their learners at the published shapes, but their
DM-Control envs are not ported (ROADMAP.md, queue 1 item 7), so ``build``
raises for them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from r2d2dpg_torch.agents.ddpg import AgentConfig, R2D2DPG
from r2d2dpg_torch.device import DeviceLike, resolve_device
from r2d2dpg_torch.envs.core import Environment
from r2d2dpg_torch.models import ActorNet, CriticNet
from r2d2dpg_torch.training.trainer import Trainer, TrainerConfig


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """One runnable experiment: env factory + net shape + agent + trainer."""

    name: str
    env_factory: Callable[..., Environment]  # (device) -> env
    agent: AgentConfig
    trainer: TrainerConfig
    use_lstm: bool = True
    pixels: bool = False
    hidden: int = 256
    compute_dtype: str = "float32"

    def build(self, device: DeviceLike = None) -> Trainer:
        """The phase-locked trainer on ``device`` (``cuda`` by default)."""
        device = resolve_device(device)
        env = self.env_factory(device)
        return Trainer(env, self.build_agent(env), self.trainer, device)

    def build_agent(self, env: Environment) -> R2D2DPG:
        """Actor and critic for ``env.spec`` (flat obs, or ``(H, W, C)``
        frames when ``pixels``) in ``compute_dtype``, and the learner."""
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")
        nets = dict(
            obs_shape=env.spec.obs_shape,
            action_dim=env.spec.action_dim,
            hidden=self.hidden,
            use_lstm=self.use_lstm,
            pixels=self.pixels,
            dtype=getattr(torch, self.compute_dtype),
        )
        return R2D2DPG(ActorNet(**nets), CriticNet(**nets), self.agent)


def _pendulum(device) -> Environment:
    from r2d2dpg_torch.envs.pendulum import Pendulum

    return Pendulum(device=device)


def _dmc(domain: str, task: str):
    def factory(device) -> Environment:
        raise NotImplementedError(
            f"DM-Control {domain}-{task} is not ported yet "
            "(ROADMAP.md, queue 1 item 7)"
        )

    return factory


# 1: classic DDPG smoke slice.
PENDULUM_DDPG = ExperimentConfig(
    name="pendulum_ddpg",
    env_factory=_pendulum,
    use_lstm=False,
    hidden=256,
    agent=AgentConfig(
        burnin=0,
        unroll=1,
        n_step=1,
        gamma=0.99,
        tau=5e-3,
        actor_lr=1e-3,
        critic_lr=1e-3,
        use_huber=False,
    ),
    trainer=TrainerConfig(
        num_envs=1,
        stride=1,
        learner_steps=1,
        batch_size=128,
        capacity=100_000,
        prioritized=False,
        min_replay=1_000,
        sigma_max=0.15,
        ladder_kind="constant",
    ),
)

# 2: the full R2D2 recurrent-replay recipe on the toy env.
PENDULUM_R2D2 = ExperimentConfig(
    name="pendulum_r2d2",
    env_factory=_pendulum,
    use_lstm=True,
    hidden=128,
    agent=AgentConfig(
        burnin=10,
        unroll=20,
        n_step=5,
        gamma=0.99,
        tau=5e-3,
        actor_lr=5e-4,
        critic_lr=1e-3,
    ),
    trainer=TrainerConfig(
        num_envs=4,
        stride=10,
        learner_steps=1,
        batch_size=64,
        capacity=50_000,
        prioritized=True,
        min_replay=200,
        sigma_max=0.3,
        ladder_alpha=3.0,
    ),
)

# 3: the headline config (walker-walk); its learner shapes are what the
# learner-step measurement runs.  The envs of configs 3-5 wait for the
# DM-Control slice.
WALKER_R2D2 = ExperimentConfig(
    name="walker_r2d2",
    env_factory=_dmc("walker", "walk"),
    use_lstm=True,
    agent=AgentConfig(
        burnin=20,
        unroll=20,
        n_step=3,
        gamma=0.99,
        tau=5e-3,
        actor_lr=1e-4,
        critic_lr=1e-3,
    ),
    trainer=TrainerConfig(
        num_envs=64,
        stride=20,
        learner_steps=4,
        batch_size=64,
        capacity=100_000,
        prioritized=True,
        min_replay=2_000,
        sigma_max=0.4,
        ladder_alpha=7.0,
    ),
)

# BASELINE.json config #3 verbatim (n-step 5, sigma 0.4).
WALKER_R2D2_NS5 = dataclasses.replace(
    WALKER_R2D2,
    name="walker_r2d2_ns5",
    agent=dataclasses.replace(WALKER_R2D2.agent, n_step=5),
    trainer=dataclasses.replace(WALKER_R2D2.trainer, sigma_max=0.4),
)

# 4: long sequences (seq-len 85 stored: burn-in 40 + unroll 40 + n-step 5).
HUMANOID_R2D2 = ExperimentConfig(
    name="humanoid_r2d2",
    env_factory=_dmc("humanoid", "run"),
    use_lstm=True,
    agent=AgentConfig(
        burnin=40,
        unroll=40,
        n_step=5,
        gamma=0.99,
        tau=5e-3,
        actor_lr=1e-4,
        critic_lr=1e-3,
    ),
    trainer=TrainerConfig(
        num_envs=256,
        stride=40,
        learner_steps=4,
        batch_size=64,
        capacity=50_000,
        prioritized=True,
        min_replay=2_000,
        sigma_max=0.4,
        ladder_alpha=7.0,
    ),
)

# 5: from pixels (CNN + LSTM on 64x64x3 uint8 frames).
CHEETAH_PIXELS = ExperimentConfig(
    name="cheetah_pixels",
    env_factory=_dmc("cheetah", "run"),
    use_lstm=True,
    pixels=True,
    agent=AgentConfig(
        burnin=20,
        unroll=20,
        n_step=5,
        gamma=0.99,
        tau=5e-3,
        actor_lr=5e-5,
        critic_lr=5e-4,
    ),
    trainer=TrainerConfig(
        num_envs=256,
        stride=20,
        learner_steps=2,
        batch_size=32,
        capacity=8_000,
        prioritized=True,
        min_replay=1_000,
        sigma_max=0.4,
        ladder_alpha=7.0,
    ),
)

# A seconds-scale smoke slice with the full R2D2 recipe at toy shapes.
PENDULUM_TINY = ExperimentConfig(
    name="pendulum_tiny",
    env_factory=_pendulum,
    use_lstm=True,
    hidden=32,
    agent=AgentConfig(burnin=2, unroll=4, n_step=2),
    trainer=TrainerConfig(
        num_envs=4,
        stride=4,
        learner_steps=1,
        batch_size=8,
        capacity=256,
        prioritized=True,
        min_replay=8,
        sigma_max=0.3,
    ),
)

CONFIGS: Dict[str, ExperimentConfig] = {
    c.name: c
    for c in (
        PENDULUM_DDPG,
        PENDULUM_R2D2,
        WALKER_R2D2,
        WALKER_R2D2_NS5,
        HUMANOID_R2D2,
        CHEETAH_PIXELS,
        PENDULUM_TINY,
    )
}


def get_config(name: str) -> ExperimentConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; have {sorted(CONFIGS)}")
    return CONFIGS[name]
