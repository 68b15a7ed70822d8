"""Named experiment configs of the port.

Port of ``r2d2dpg_tpu/configs/__init__.py``, every config with the JAX
constants and env arguments: ``pendulum_tiny``, ``pendulum_ddpg`` and
``pendulum_r2d2`` on the tensor Pendulum; ``walker_r2d2`` and
``walker_r2d2_ns5`` (walker-walk, action repeat 2), ``humanoid_r2d2``
(humanoid-run, action repeat 2) and ``cheetah_pixels`` (cheetah-run from
64x64 frames, action repeat 4) on the host DM-Control pool
(``envs/dmc_host.py``), which needs mujoco and dm_control where it runs.
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
        """The phase-locked trainer on ``device`` (``cuda`` by default);
        with ``overlap_learner`` the host-pool trainer on a mesh of one."""
        device = resolve_device(device)
        env = self.env_factory(device)
        agent = self.build_agent(env)
        if self.trainer.overlap_learner:
            # The interleaved learner lives in HostSPMDTrainer; the base
            # Trainer would ignore the flag, so it refuses.
            if not getattr(env, "batched", False):
                raise ValueError(
                    "overlap_learner requires a host-pool env (pure-JAX "
                    "envs collect in-graph; there is no host gap to hide "
                    "updates under)"
                )
            from r2d2dpg_torch.parallel import HostSPMDTrainer, make_mesh

            return HostSPMDTrainer(env, agent, self.trainer, make_mesh(1, device))
        return Trainer(env, agent, self.trainer, device)

    def build_agent(self, env: Environment, axis_name=None) -> R2D2DPG:
        """Actor and critic for ``env.spec`` (flat obs, or ``(H, W, C)``
        frames when ``pixels``) in ``compute_dtype``, and the learner;
        ``axis_name`` overrides the agent config's."""
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
        agent_cfg = (
            dataclasses.replace(self.agent, axis_name=axis_name)
            if axis_name != self.agent.axis_name
            else self.agent
        )
        return R2D2DPG(ActorNet(**nets), CriticNet(**nets), agent_cfg)

    def build_dp_learner(self, mesh, collect_local: bool,
                         device: DeviceLike = None) -> Trainer:
        """Data-parallel learner on ``mesh`` (``--learner-dp D``): replay
        split into capacity blocks, the learner batch split over the ranks
        (``parallel/dp_learner.py``).  ``collect_local`` says this process
        also collects (``--actors 0``): that in-process path needs a
        pure-torch env; under ``--actors N`` the actors collect."""
        from r2d2dpg_torch.parallel import DPLearnerTrainer

        device = resolve_device(mesh.device if device is None else device)
        env = self.env_factory(device)
        if collect_local and getattr(env, "batched", False):
            raise ValueError(
                "--learner-dp with --actors 0 requires a pure-JAX env "
                "config (host-pool envs scale with --spmd / "
                "HostSPMDTrainer); with --actors N the fleet collects and "
                "any config works"
            )
        if self.trainer.overlap_learner:
            raise ValueError(
                "overlap_learner requires a host-pool env trainer "
                "(HostSPMDTrainer); the dp learner would silently ignore it"
            )
        agent = self.build_agent(env, axis_name=None)
        return DPLearnerTrainer(env, agent, self.trainer, mesh)

    def build_spmd(self, mesh, device: DeviceLike = None) -> Trainer:
        """Every rank of ``mesh`` runs the whole loop on its share of the
        envs (``--spmd D``): ``SPMDTrainer`` for tensor envs
        (``parallel/spmd.py``), ``HostSPMDTrainer`` for host-pool envs
        (``parallel/hybrid.py``)."""
        from r2d2dpg_torch.parallel import DP_AXIS, HostSPMDTrainer, SPMDTrainer

        device = resolve_device(mesh.device if device is None else device)
        env = self.env_factory(device)
        if getattr(env, "batched", False):
            agent = self.build_agent(env, axis_name=None)
            return HostSPMDTrainer(env, agent, self.trainer, mesh)
        if self.trainer.overlap_learner:
            raise ValueError(
                "overlap_learner requires a host-pool env (pure-JAX envs "
                "collect in-graph; there is no host gap to hide updates "
                "under) — SPMDTrainer would silently ignore it"
            )
        agent = self.build_agent(env, axis_name=DP_AXIS)
        return SPMDTrainer(env, agent, self.trainer, mesh)


def _pendulum(device) -> Environment:
    from r2d2dpg_torch.envs.pendulum import Pendulum

    return Pendulum(device=device)


def _dmc(domain: str, task: str, pixels: bool = False, action_repeat: int = 1):
    def factory(device) -> Environment:
        from r2d2dpg_torch.envs.dmc_host import DMCHostEnv

        return DMCHostEnv(
            domain, task, pixels=pixels, action_repeat=action_repeat, device=device
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
# learner-step measurement runs.
WALKER_R2D2 = ExperimentConfig(
    name="walker_r2d2",
    env_factory=_dmc("walker", "walk", action_repeat=2),
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
    env_factory=_dmc("humanoid", "run", action_repeat=2),
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
    env_factory=_dmc("cheetah", "run", pixels=True, action_repeat=4),
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
