"""SPMD trainer: every rank runs the whole loop on its share of the fleet.

Port of ``r2d2dpg_tpu/parallel/spmd.py``.  JAX runs the phases under
``shard_map`` over a ``dp`` mesh; here each of D processes runs the base
``Trainer``'s phases on its ``1/D`` share, coupled only through the
collectives:

- the env fleet, the window and the replay arena split over the ranks
  (``num_envs/D`` lanes and ``capacity/D`` slots each): a sequence is
  stored on the rank whose envs produced it and never moves;
- the learner is data-parallel: each rank samples ``batch_size/D`` from its
  own arena, launches the scatter kernel on it, and the gradients are
  averaged over the mesh (``AgentConfig.axis_name``, one flattened buffer
  per net);
- exploration stays globally heterogeneous: rank ``r`` takes its lanes'
  rows of the global sigma ladder;
- everything else (params, optimizer state, counters) is replicated, kept
  equal by construction (averaged gradients, summed episode counters).

``init`` builds the GLOBAL state from the global draws (the reset of all
``num_envs`` lanes), then keeps this rank's rows, so rank ``r``'s envs
start where JAX's device ``r`` starts.  After that rank ``r`` draws from
its own stream (``Draws.fold``, the rule in ``training/draws.py``): rank 0
keeps the run's draws, so ``--spmd 1`` is bitwise the plain ``Trainer``.
The arena's gauges (occupancy, priority sum) read this rank's arena, as
JAX's read its local shard.

A checkpoint holds the global state in JAX's layout (``parallel/layout.py``):
the env side, the window, the arena's buffers and the episode returns
concatenated over the ranks, the rest rank 0's, and one draw stream per
rank, so a full checkpoint resumes only at its own world size.
"""

from __future__ import annotations

import dataclasses

import torch

from r2d2dpg_torch.agents.ddpg import R2D2DPG
from r2d2dpg_torch.envs.core import Environment
from r2d2dpg_torch.ops import sigma_ladder
from r2d2dpg_torch.parallel.layout import MeshState
from r2d2dpg_torch.parallel.mesh import DP_AXIS, Mesh
from r2d2dpg_torch.training.trainer import Metrics, Trainer, TrainerConfig, TrainerState
from r2d2dpg_torch.tree import tree_map

# The env-side fields of TrainerState, split over the ranks by lane (axis 0);
# the rest is replicated or, for the arena, built local.
ENV_FIELDS = ("env_state", "obs", "reset", "actor_carry", "critic_carry",
              "noise_state", "window", "episode_return")


def pmean_metrics(mesh: Mesh, metrics: Metrics) -> Metrics:
    """The mean over the mesh of a dict of 0-dim metrics, in one collective."""
    if not metrics:
        return metrics
    names = list(metrics)
    flat = mesh.pmean_(torch.stack([metrics[k].float() for k in names]))
    return dict(zip(names, flat.unbind()))


class SPMDTrainer(MeshState, Trainer):
    """Trainer whose phases run on every rank of a ``dp`` mesh.

    ``config`` is global (fleet-wide env count, global batch size, total
    replay capacity); each rank runs the base Trainer on its ``1/D`` share.
    """

    axis = DP_AXIS

    def __init__(
        self,
        env: Environment,
        agent: R2D2DPG,
        config: TrainerConfig,
        mesh: Mesh,
    ):
        if getattr(env, "batched", False):
            raise ValueError(
                "SPMDTrainer does not support host-callback (batched) envs: "
                "ordered io_callback cannot run under shard_map. Multi-chip "
                "host-env pools need one pool per host (see docs/PARITY.md)."
            )
        if agent.config.axis_name != DP_AXIS:
            raise ValueError(
                "SPMDTrainer requires AgentConfig.axis_name == "
                f"{DP_AXIS!r} so learner gradients sync over the mesh "
                f"(got {agent.config.axis_name!r})"
            )
        d = mesh.shape[DP_AXIS]
        for field in ("num_envs", "batch_size", "capacity", "min_replay"):
            if getattr(config, field) % d:
                raise ValueError(
                    f"TrainerConfig.{field}={getattr(config, field)} must "
                    f"be divisible by the mesh size {d}"
                )
        self.mesh = mesh
        self.num_devices = d
        self.global_config = config
        local = dataclasses.replace(
            config,
            num_envs=config.num_envs // d,
            batch_size=config.batch_size // d,
            capacity=config.capacity // d,
            min_replay=config.min_replay // d,
        )
        super().__init__(env, agent.bind_mesh(mesh), local, mesh.device)
        self.global_envs = config.num_envs

    # ----------------------------------------------------- distribution hooks
    def _local_sigmas(self) -> torch.Tensor:
        """This rank's lanes of the global noise ladder."""
        g = self.global_config
        sigmas = sigma_ladder(
            g.num_envs,
            sigma_max=g.sigma_max,
            alpha=g.ladder_alpha,
            kind=g.ladder_kind,
            device=self.device,
        )
        return sigmas[self.mesh.block(g.num_envs)]

    def _psum(self, x: torch.Tensor) -> torch.Tensor:
        return self.mesh.psum_(x)

    def _pmean(self, metrics: Metrics) -> Metrics:
        return pmean_metrics(self.mesh, metrics)

    def _fold_axis(self, draws):
        return draws.fold(self.mesh.rank)

    # ------------------------------------------------------ global layout
    def _is_sharded(self, path) -> bool:
        """JAX's ``_state_spec``: the env side and the arena's buffers are
        split by lane / slot; the rest is replicated."""
        return path[0] in ENV_FIELDS or (
            path[0] == "arena" and path[1:2] in (("data",), ("priority",), ("meta",)))

    @property
    def draw_streams(self) -> int:
        return self.num_devices

    # ------------------------------------------------------------------ init
    def init(self, draws=None) -> TrainerState:
        """The global state from the global draws, then this rank's lanes.

        The arena is built at the local capacity directly (it is empty at
        init, so that is the global arena's block)."""
        local_cfg = self.config
        try:
            self.config = self.global_config
            state = super().init(draws)
        finally:
            self.config = local_cfg
        rows = self.mesh.block(self.global_config.num_envs)
        mine = {f: tree_map(lambda x: x[rows].clone(), getattr(state, f))
                for f in ENV_FIELDS}
        return dataclasses.replace(state, **mine)
