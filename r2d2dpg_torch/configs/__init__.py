"""Named experiment configs of the port.

Port of ``r2d2dpg_tpu/configs/__init__.py`` for the configs this slice runs:
``pendulum_tiny``, ``pendulum_ddpg`` and ``pendulum_r2d2`` train end to
end.  ``walker_r2d2`` carries its agent and trainer constants (the learner
shapes the headline benchmark measures), but its DM-Control env waits for
a later slice, so building it raises.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

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
        if self.pixels:
            raise NotImplementedError(
                "pixel torsos are not ported yet (ROADMAP.md, queue 1 item 2)"
            )
        if self.compute_dtype != "float32":
            raise NotImplementedError(
                "the bf16 mixed-precision cell is not ported yet "
                "(ROADMAP.md, queue 1 item 2)"
            )
        (obs_dim,) = env.spec.obs_shape
        act_dim = env.spec.action_dim
        actor = ActorNet(obs_dim, act_dim, hidden=self.hidden, use_lstm=self.use_lstm)
        critic = CriticNet(obs_dim, act_dim, hidden=self.hidden, use_lstm=self.use_lstm)
        return R2D2DPG(actor, critic, self.agent)


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
# learner-step measurement runs.  The env waits for the DM-Control slice.
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
    c.name: c for c in (PENDULUM_DDPG, PENDULUM_R2D2, WALKER_R2D2, PENDULUM_TINY)
}


def get_config(name: str) -> ExperimentConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; have {sorted(CONFIGS)}")
    return CONFIGS[name]
