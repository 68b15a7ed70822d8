"""The host-pool trainer: device compute over a ``dp`` mesh, physics on the host.

Port of ``r2d2dpg_tpu/parallel/hybrid.py`` (``HostSPMDTrainer``).  A
host-stepped env (``envs/dmc_host.py::DMCHostEnv``) cannot run inside a
device program, so the collect is a host loop: once per collected step the
``[E, A]`` actions come to the host, the pool steps every env, and the
step's results go back to the device as one copy.  Everything else (the
policy step, noise, the window, the replay arena, the learner) stays on the
device.

JAX lays the state out over a mesh from one process and lets GSPMD place
the collectives; the port runs one process per device over
``torch.distributed`` (NCCL on cards, gloo on the CPU), with JAX's layout
mapped onto ranks:

| state | layout |
|---|---|
| env pool, obs, carries, noise, window, episode returns | ``num_envs/D`` lanes per rank, each rank its own pool |
| replay arena | replicated: every rank all-gathers the ``E`` fresh sequences and their initial priorities before the add (``_reshard_add``) |
| params, optimizer state, draws, counters | replicated |
| learner batch | every rank draws the same global ``B`` and learns on its ``B/D`` rows (``_reshard_batch``); gradients averaged (``AVG``) |
| write-back | the ``B`` priorities all-gathered, the scatter kernel on every rank's whole arena (``replay/arena.py::ReplicatedArena``) |

The draws are replicated, as JAX's key is.  A per-lane draw (the reset's
seeds, the exploration normal) is drawn for all ``E`` lanes and the rank
keeps its rows, so rank ``r``'s lanes start and explore as JAX's device
``r`` lanes do, and a world of one is bitwise the plain ``Trainer`` on the
same env.  (JAX's multi-process form folds the process index into the
reset key instead; its one-process mesh, which the tests hold the port to,
draws the global seeds.)

The schedules are JAX's:

- ``_stride_loop``: per step act, fetch the actions, the optional
  ``on_step(t)`` hook, ``host_step``, the results back in; then one absorb
  of the phase.  The pipelined executor's collector thread runs it on its
  own modules (``training/pipeline.py``).
- ``_host_collect(learn=True)`` (``overlap_learner``): the phase's learner
  steps are dispatched one at a time after step ``t``'s actions reached the
  host and before its physics, spread so that update ``sub`` goes at the
  first ``t`` with ``(sub + 1) * stride <= (t + 1) * learner_steps``.  The
  device runs an update while the host is in the physics step.  Every
  dispatch is on the one current stream, so ``act(t + 1)`` queues behind
  the update, as JAX's device queue orders it.  The updates sample the
  arena as of the previous emit (the phase's sequences enter replay after
  them).
- ``collect_phase``, ``fill_phase`` and ``train_phase``.

``r2d2dpg_hybrid_host_env_step_seconds`` times the host step as the loop
sees it (physics and numpy marshalling); the pool's own
``r2d2dpg_envpool_step_seconds`` isolates the physics.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from r2d2dpg_torch.agents.ddpg import R2D2DPG
from r2d2dpg_torch.envs.core import HostUpload
from r2d2dpg_torch.envs.dmc_host import fetch_actions
from r2d2dpg_torch.obs import get_registry
from r2d2dpg_torch.ops import sigma_ladder
from r2d2dpg_torch.parallel.layout import MeshState
from r2d2dpg_torch.parallel.mesh import DP_AXIS, Mesh, sharded
from r2d2dpg_torch.parallel.spmd import ENV_FIELDS, pmean_metrics
from r2d2dpg_torch.replay.arena import ReplicatedArena
from r2d2dpg_torch.training.assembler import StepRecord
from r2d2dpg_torch.training.trainer import Metrics, Trainer, TrainerConfig, TrainerState
from r2d2dpg_torch.tree import tree_map
from r2d2dpg_torch.utils.profiling import annotate, timed


class _LaneDraws:
    """The replicated draw stream as one rank's lanes see it: a per-lane
    draw is made for every lane of the fleet, and the rank keeps its rows."""

    def __init__(self, draws, mesh: Mesh, lanes: int):
        self.draws, self.mesh, self.lanes = draws, mesh, lanes

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        return x[self.mesh.block(self.lanes)]

    def normal(self, shape):
        return self._rows(self.draws.normal((self.lanes,) + tuple(shape[1:])))

    def randint(self, shape, low, high):
        return self._rows(self.draws.randint((self.lanes,) + tuple(shape[1:]), low, high))


class HostSPMDTrainer(MeshState, Trainer):
    """dp training with the env fleet stepped from the host.

    ``config`` is global (fleet-wide env count, global batch size, total
    capacity)."""

    axis = None  # the collectives live in the hooks, the arena and the agent

    def __init__(
        self,
        env,
        agent: R2D2DPG,
        config: TrainerConfig,
        mesh: Mesh,
    ):
        if not getattr(env, "batched", False) or not hasattr(env, "host_step"):
            raise ValueError(
                "HostSPMDTrainer is for host-pool envs (DMCHostEnv); pure-JAX "
                "envs scale with parallel.SPMDTrainer instead"
            )
        if agent.config.axis_name is not None:
            raise ValueError(
                "HostSPMDTrainer uses pjit-style gradient sync; build the "
                "agent with axis_name=None (got "
                f"{agent.config.axis_name!r})"
            )
        # One process per device: the process count is the mesh size.
        self._nproc = mesh.size
        if config.num_envs % max(self._nproc, 1):
            raise ValueError(
                f"TrainerConfig.num_envs={config.num_envs} must be divisible "
                f"by the process count {self._nproc} (one env pool per host, "
                f"each owning num_envs/process_count envs)"
            )
        d = mesh.shape[DP_AXIS]
        # The arena is replicated, so only the split axes divide the mesh.
        for field in ("num_envs", "batch_size"):
            if getattr(config, field) % d:
                raise ValueError(
                    f"TrainerConfig.{field}={getattr(config, field)} must "
                    f"be divisible by the mesh size {d}"
                )
        self.mesh = mesh
        self.num_devices = d
        self.global_config = config
        local = dataclasses.replace(config, num_envs=config.num_envs // d)
        super().__init__(env, agent.bind_mesh(mesh, axis_name=DP_AXIS), local,
                         mesh.device)
        self.global_envs = config.num_envs
        self.arena = ReplicatedArena(
            config.capacity, mesh,
            prioritized=config.prioritized, alpha=config.priority_alpha,
        )
        self._upload = HostUpload(self.device)
        self._obs_host_step = get_registry().histogram(
            "r2d2dpg_hybrid_host_env_step_seconds",
            "host env-step boundary latency in the hybrid stride loop",
        )

    # ----------------------------------------------------- distribution hooks
    def _local_sigmas(self) -> torch.Tensor:
        """This rank's lanes of the global noise ladder."""
        g = self.global_config
        sigmas = sigma_ladder(
            g.num_envs, sigma_max=g.sigma_max, alpha=g.ladder_alpha,
            kind=g.ladder_kind, device=self.device,
        )
        return sigmas[self.mesh.block(g.num_envs)]

    def _psum(self, x: torch.Tensor) -> torch.Tensor:
        # At one rank the sum is the identity; skipping it keeps the
        # pipelined collector thread free of collectives.
        return x if self.num_devices == 1 else self.mesh.psum_(x)

    def _pmean(self, metrics: Metrics) -> Metrics:
        return pmean_metrics(self.mesh, metrics)

    def _lane_draws(self, draws):
        """Per-lane draws for this rank's lanes (the stream itself at D = 1)."""
        if self.num_devices == 1:
            return draws
        return _LaneDraws(draws, self.mesh, self.global_envs)

    def _env_reset(self, draws):
        """Reset this rank's pool: its rows of the fleet's global seeds."""
        return self.env.reset(self.config.num_envs, self._lane_draws(draws))

    def _reshard_add(self, seq, prios):
        """Every rank's fresh sequences and initial priorities, gathered for
        the replicated arena's add (the priorities ran on this rank's rows)."""
        return tree_map(self.mesh.all_gather, seq), self.mesh.all_gather(prios)

    def _reshard_batch(self, batch, weights, normal):
        """This rank's ``B/D`` rows of the replicated global batch."""
        place = sharded(self.mesh)
        return (tree_map(place, batch), place(weights),
                None if normal is None else place(normal, axis=1))

    def _is_sharded(self, path) -> bool:
        """JAX's hybrid layout: the env side by lane (the env state, a host
        pool's token, replicated); the arena replicated."""
        return path[0] in ENV_FIELDS and path[0] != "env_state"

    @property
    def replay_fill_phases(self) -> int:
        """Phases to ``min_replay`` sequences: every emit adds the fleet's."""
        return -(-self.config.min_replay // self.global_envs)

    # ------------------------------------------------------------ host loop
    def _stride_loop(self, state, behavior, critic_params, nets=None, on_step=None):
        """The host stride loop: per step the policy dispatch, the action
        fetch, the optional ``on_step(t)`` hook, the host step and the
        results' one copy back; then one absorb of the phase.  ``state`` is
        a ``TrainerState`` or the pipelined collector's ``CollectorState``;
        only the env-side fields and the draws are read."""
        if nets is None:
            nets = (self.agent.actor, self.agent.critic)
        draws = self._lane_draws(state.draws)
        env_state, obs, reset = state.env_state, state.obs, state.reset
        a_carry, c_carry = state.actor_carry, state.critic_carry
        noise_st = state.noise_state
        records = []
        for t in range(self.config.stride):
            pre_carries = {"actor": a_carry, "critic": c_carry}
            action, a_carry, c_carry, noise_st = self._policy_step(
                nets, behavior, critic_params, obs, reset, a_carry, c_carry,
                noise_st, draws,
            )
            action_np = fetch_actions(action)
            if on_step is not None:
                on_step(t)
            # The one host <-> device boundary of a collected step.
            with timed(self._obs_host_step), annotate("hybrid/host_env_step"):
                ts = self._upload.upload(*self.env.host_step(action_np))
            records.append(StepRecord(
                obs=obs, action=action, reward=ts.reward, discount=ts.discount,
                reset=reset, carries=pre_carries,
            ))
            obs, reset = ts.obs, ts.reset
        with annotate("hybrid/absorb"):
            return self._absorb(state, records, env_state, obs, reset, a_carry,
                                c_carry, noise_st)

    def _host_collect(
        self, state: TrainerState, learn: bool = False
    ) -> Tuple[TrainerState, Optional[Dict[str, torch.Tensor]]]:
        """``stride`` host-stepped env steps; with ``learn=True`` the phase's
        ``learner_steps`` updates are dispatched between them (the module
        docstring's spread rule).  Returns the state and, when learning, the
        mean of the updates' metrics over the steps and the mesh."""
        cfg = self.config
        behavior = self._behavior_params(state)
        if cfg.param_sync_every > 0:
            state = dataclasses.replace(state, behavior_params=behavior)
        critic_params = self.agent.behavior_critic_params(state.train)
        train, arena = state.train, state.arena
        n_sub = cfg.learner_steps if learn else 0
        sub = 0
        metrics_acc = []

        def dispatch_substeps(t: int) -> None:
            # After step t's actions crossed to the host (so act never waits
            # behind an update) and before its physics (so the update runs
            # under it).
            nonlocal train, arena, sub
            while sub < n_sub and (sub + 1) * cfg.stride <= (t + 1) * n_sub:
                with annotate("hybrid/learn_substep"):
                    train, arena, m = self._learn_step(train, arena, state.draws)
                metrics_acc.append(m)
                sub += 1

        state = self._stride_loop(
            state, behavior, critic_params,
            on_step=dispatch_substeps if n_sub else None,
        )
        if not learn:
            return state, None
        state = dataclasses.replace(state, train=train, arena=arena)
        if not metrics_acc:  # learner_steps=0: a collect-only train phase
            return state, {}
        metrics = {k: torch.stack([m[k] for m in metrics_acc]).mean()
                   for k in metrics_acc[0]}
        return state, self._pmean(metrics)

    def _collect(self, state, behavior=None, critic_params=None, nets=None):
        """The phase-locked collect (a ``TrainerState``), or the pipelined
        collector's (its snapshot params and its own modules given)."""
        if behavior is None:
            return self._host_collect(state)[0]
        return self._stride_loop(state, behavior, critic_params, nets=nets)

    # --------------------------------------------------------------- phases
    def train_phase(self, state: TrainerState) -> Tuple[TrainerState, Metrics]:
        if not self.config.overlap_learner:
            state, _ = self._host_collect(state)
            with annotate("hybrid/emit_learn"):
                return self._learn(self._emit_and_add(state))
        state, metrics = self._host_collect(state, learn=True)
        with annotate("hybrid/emit_add"):
            return self._emit_and_add(state), metrics
