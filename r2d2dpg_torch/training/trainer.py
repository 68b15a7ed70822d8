"""The phase-locked trainer: actor phase + learner phase on one device.

Port of ``r2d2dpg_tpu/training/trainer.py``.  The static phase schedule is
the same:

  ``collect_phase``  env stepping + window shift only (warm-up);
  ``fill_phase``     + sequence emission into the replay arena;
  ``train_phase``    + K learner steps with prioritized sampling, IS
                     weights, priority write-back (the CUDA kernel on a
                     card), Polyak updates.

The JAX program scans over env steps and learner steps inside one jitted
phase; the port runs the same steps as Python loops over torch ops.  Every
random draw goes through the state's draws object (``training/draws.py``).
With ``param_sync_every == 0`` the actors act with the fresh learner params;
K > 0 refreshes a behaviour snapshot every K phases.

``_collect`` takes the nets it runs (``nets``, the agent's by default), so
the pipelined executor's collector thread runs its own module copies
(``training/pipeline.py``); ``_absorb`` folds a phase's step records into
the state, shared with the host-pool trainer's stride loop.  A host-stepped
env (``batched``, ``envs/dmc_host.py``) needs no branch here: every env of
the port steps all its lanes in one call.  ``_learn_many(prefetch=True)`` is the
executor's double-buffered drain: batch k+1 is sampled before update k's
priority write-back (its draw order is in ``training/draws.py``).

``Trainer.run`` opens the device monitor's run window (``obs/device.py``)
and the log cadence publishes the trainer's, the arena's and the quality
plane's gauges from its one host fetch (``_obs_publish``).
``train_phase`` opens the spans ``trainer/collect``, ``trainer/emit_add``
and ``trainer/learn`` (id: the phase index), and ``_update_step`` the
learner's (id: the trainer's update count; ``utils/profiling.py``).

Distribution hooks, each the identity here, where the JAX trainer has
them (``parallel/spmd.py`` and ``parallel/dp_learner.py`` override them):
``_local_sigmas`` (this rank's slice of the global ladder), ``_psum`` (the
completed-episode counters), ``_pmean`` (the learner metrics),
``_fold_axis`` (the rank's draw stream, folded once in ``init``: the
port's draws are a stream, not a key), ``_reshard_add`` (the fresh rows
before the arena add), ``_reshard_batch`` (the learner step's rows, IS
weights and smoothing normal), ``_put_staged`` (a fleet or sampler batch
before the drain or pull learn), ``_log_extra_refs`` /
``_log_extra_publish`` (extra values on the log cadence's one fetch),
``_agree`` (rank 0's value of a host decision, such as the ``minutes``
deadline), ``_env_reset`` (the fleet's reset: a host-pool trainer's rank
resets its own rows), and the checkpoint hooks ``global_field`` / ``global_state`` /
``local_state`` / ``_global_template`` / ``_check_replicated`` (the
global state a checkpoint holds, ``parallel/layout.py``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from r2d2dpg_torch.agents.ddpg import R2D2DPG, TrainState
from r2d2dpg_torch.envs.core import Environment
from r2d2dpg_torch.obs import get_device_monitor, get_registry
from r2d2dpg_torch.obs.device import count_flops
from r2d2dpg_torch.obs.quality import get_quality_plane
from r2d2dpg_torch.ops import (
    anneal_beta,
    gaussian_noise,
    importance_weights,
    ou_step,
    sigma_ladder,
)
from r2d2dpg_torch.replay.arena import ArenaState, ReplayArena
from r2d2dpg_torch.training.assembler import (
    StepRecord,
    emit,
    init_window,
    shift_in,
    stack_steps,
)
from r2d2dpg_torch.training.draws import Draws
from r2d2dpg_torch.utils.profiling import annotate, span_id

Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """Static orchestration hyperparameters (the JAX package's fields)."""

    num_envs: int = 64
    stride: int = 20  # env steps per phase == emission stride
    learner_steps: int = 1  # learner updates per phase
    batch_size: int = 64
    capacity: int = 100_000
    prioritized: bool = True
    priority_alpha: float = 0.6
    beta0: float = 0.4
    beta_steps: int = 100_000
    min_replay: int = 1_000  # sequences before training starts
    sigma_max: float = 0.4
    ladder_alpha: float = 7.0
    ladder_kind: str = "geometric"
    noise: str = "gaussian"  # "gaussian" | "ou" | "none"
    param_sync_every: int = 0  # 0 = always-fresh behavior params
    initial_priority: str = "td"  # "td" | "max"
    # Host-pool trainers only (parallel/hybrid.py): dispatch the phase's
    # learner steps one at a time between env steps, so each runs on the
    # device while the host is in the physics step.  Its learner samples
    # the arena as of the previous emit.
    overlap_learner: bool = False
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class TrainerState:
    """Everything the training loop threads through phases.

    The arena's buffers are updated in place (``replay/arena.py``); every
    other field is replaced, never mutated.
    """

    env_state: Any  # batched env state [E, ...]
    obs: torch.Tensor  # [E, obs]
    reset: torch.Tensor  # [E] — 1 where obs starts a new episode
    actor_carry: Any
    critic_carry: Any
    noise_state: torch.Tensor  # [E, A] (OU process state; zeros for gaussian)
    window: StepRecord
    arena: ArenaState
    train: TrainState
    behavior_params: Any  # stale actor params (== train.actor_params when fresh)
    draws: Any  # Draws, or a test's ReplayDraws
    phase_idx: int
    env_steps: int
    episode_return: torch.Tensor  # [E] running returns
    completed_return_sum: torch.Tensor  # 0-dim
    completed_count: torch.Tensor  # 0-dim


class Trainer:
    """Phase functions for (env, agent, config) on one device.

    ``axis`` names the mesh axis the phases reduce over (None: one
    device); ``global_envs`` is the fleet-wide env count."""

    axis: Optional[str] = None

    def __init__(
        self,
        env: Environment,
        agent: R2D2DPG,
        config: TrainerConfig,
        device: torch.device,
    ):
        if config.noise not in ("gaussian", "ou", "none"):
            raise ValueError(f"unknown noise {config.noise!r}")
        self.env = env
        self.agent = agent
        self.config = config
        self.device = device
        self.seq_len = agent.config.seq_len
        self.arena = ReplayArena(
            config.capacity,
            prioritized=config.prioritized,
            alpha=config.priority_alpha,
        )
        self.global_envs = config.num_envs
        self.sigmas = self._local_sigmas()
        # Learner updates this trainer has run: the id of each update's spans.
        self._updates = 0
        # Telemetry: registration is idempotent, so every Trainer of the
        # process shares one instrument per name.
        self._device = get_device_monitor().install()
        reg = get_registry()
        self._obs_env_steps = reg.gauge(
            "r2d2dpg_trainer_env_steps", "fleet-wide env steps collected"
        )
        self._obs_learner_steps = reg.gauge(
            "r2d2dpg_trainer_learner_steps", "learner updates applied"
        )
        self._obs_return = reg.gauge(
            "r2d2dpg_trainer_episode_return_mean",
            "mean return of episodes completed since the previous log",
        )
        self._obs_episodes = reg.counter(
            "r2d2dpg_trainer_episodes_total", "episodes completed"
        )

    def _local_sigmas(self) -> torch.Tensor:
        """This trainer's per-lane exploration sigmas: the whole ladder over
        ``num_envs`` lanes.  A subclass returns its own slice of a wider
        ladder (a fleet actor's, ``fleet/actor.py``)."""
        cfg = self.config
        return sigma_ladder(
            cfg.num_envs,
            sigma_max=cfg.sigma_max,
            alpha=cfg.ladder_alpha,
            kind=cfg.ladder_kind,
            device=self.device,
        )

    def _psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum a per-rank partial over the mesh (identity on one device)."""
        return x

    def _pmean(self, metrics: Metrics) -> Metrics:
        """Mean of the learner metrics over the mesh (identity here)."""
        return metrics

    def _fold_axis(self, draws):
        """The draw stream this rank continues on after ``init``'s
        replicated draws (identity on one device)."""
        return draws

    def _reshard_add(self, seq, prios):
        """Hook: relayout emitted sequences + priorities before the arena
        add, after the initial-priority forward ran in their own layout."""
        return seq, prios

    def _reshard_batch(self, batch, weights, normal):
        """Hook: this rank's share of a learner step's batch rows, IS
        weights ``[B]`` and smoothing normal ``[U + n, B, A]`` (or None)."""
        return batch, weights, normal

    def _put_staged(self, staged, axis: int = 0):
        """Hook: place a fleet batch tree for the learner: axis 0 is the
        staged fleet layout (leaves ``[B, ...]``), axis 1 the sampler's
        pulled layout (``[K, B, ...]``).  Identity here."""
        del axis
        return staged

    def _log_extra_refs(self, arena_state) -> list:
        """Hook: extra device tensors for the log cadence's one fetch."""
        return []

    def _log_extra_publish(self, fetched) -> None:
        """Hook: fold the fetched values of ``_log_extra_refs`` (one list
        per ref) onto the registry."""

    def _agree(self, flag: bool) -> bool:
        """Hook: rank 0's ``flag`` on every rank (identity here)."""
        return flag

    # Independent draw streams the state carries (``--spmd D``: one per rank).
    draw_streams = 1

    def global_field(self, state: TrainerState, name: str) -> Any:
        """Hook: one top-level field of the global state (identity here)."""
        return getattr(state, name)

    def global_state(self, state: TrainerState) -> TrainerState:
        """Hook: the global state a checkpoint holds (identity here)."""
        return state

    def local_state(self, global_state: TrainerState) -> TrainerState:
        """Hook: this rank's slice of a global state (identity here)."""
        return global_state

    def _global_template(self, state: TrainerState) -> TrainerState:
        """Hook: a restore template of the global state's shapes."""
        return state

    def _check_replicated(self, state, extra=None) -> None:
        """Hook: hold the replicated leaves equal across ranks."""

    # ------------------------------------------------------------------ init
    def _env_reset(self, draws):
        """Hook: reset the fleet (a host-pool trainer resets its own rows)."""
        return self.env.reset(self.config.num_envs, draws)

    def init(self, draws=None) -> TrainerState:
        cfg = self.config
        draws = Draws(cfg.seed, self.device) if draws is None else draws
        env_state, ts = self._env_reset(draws)
        e, a_dim = cfg.num_envs, self.env.spec.action_dim
        # Params are initialized on the CPU from the seed, then moved, so a
        # seed means the same nets on every device.
        train = self.agent.init(
            torch.Generator().manual_seed(cfg.seed), self.device
        )
        example_action = torch.zeros(e, a_dim, device=self.device)
        actor_carry = self.agent.actor.initial_carry(e, self.device)
        critic_carry = self.agent.critic.initial_carry(e, self.device)
        record = StepRecord(
            obs=ts.obs,
            action=example_action,
            reward=ts.reward,
            discount=ts.discount,
            reset=ts.reset,
            carries={"actor": actor_carry, "critic": critic_carry},
        )
        window = init_window(record, self.seq_len)
        arena_state = self.arena.init_state(emit(window))
        zero = torch.zeros((), device=self.device)
        return TrainerState(
            env_state=env_state,
            obs=ts.obs,
            reset=ts.reset,
            actor_carry=actor_carry,
            critic_carry=critic_carry,
            noise_state=torch.zeros(e, a_dim, device=self.device),
            window=window,
            arena=arena_state,
            train=train,
            behavior_params={k: v.clone() for k, v in train.actor_params.items()},
            draws=self._fold_axis(draws),
            phase_idx=0,
            env_steps=0,
            episode_return=torch.zeros(e, device=self.device),
            completed_return_sum=zero,
            completed_count=zero.clone(),
        )

    # --------------------------------------------------------- phase pieces
    def _behavior_params(self, state: TrainerState):
        k = self.config.param_sync_every
        if k == 0 or state.phase_idx % k == 0:
            return state.train.actor_params
        return state.behavior_params

    @torch.no_grad()
    def _policy_step(
        self, nets, behavior, critic_params, obs, reset, a_carry, c_carry,
        noise_st, draws,
    ):
        """One fleet-wide policy step: action + noise + clip + carry advance.

        ``nets`` is the (actor, critic) module pair that runs the params."""
        cfg = self.config
        actor, critic = nets
        action, a_carry = actor.apply_params(behavior, obs, a_carry, reset)
        if cfg.noise == "gaussian":
            action = action + gaussian_noise(
                action, self.sigmas, normal=draws.normal(action.shape)
            )
        elif cfg.noise == "ou":
            noise_st = torch.where(reset[:, None] > 0, 0.0, noise_st)
            noise_st = ou_step(
                noise_st, self.sigmas, normal=draws.normal(noise_st.shape)
            )
            action = action + noise_st
        action = action.clamp(-1.0, 1.0)
        _, c_carry = critic.apply_params(critic_params, obs, action, c_carry, reset)
        return action, a_carry, c_carry, noise_st

    @torch.no_grad()
    def _collect(
        self, state, behavior=None, critic_params=None, nets=None
    ) -> TrainerState:
        """``stride`` env steps of every lane: policy, noise, env, bookkeeping.

        ``behavior`` / ``critic_params`` default to the state's own learner
        params and ``nets`` to the agent's (actor, critic) modules (the
        phase-locked path).  The pipelined collector passes all three: its
        state has no learner subtree, and it must never run the learner
        thread's modules (``functional_call`` swaps a module's parameters
        for the length of a call)."""
        cfg = self.config
        if behavior is None:
            behavior = self._behavior_params(state)
        if critic_params is None:
            critic_params = self.agent.behavior_critic_params(state.train)
        if nets is None:
            nets = (self.agent.actor, self.agent.critic)
        draws = state.draws
        env_state, obs, reset = state.env_state, state.obs, state.reset
        a_carry, c_carry = state.actor_carry, state.critic_carry
        noise_st = state.noise_state
        records = []
        for _ in range(cfg.stride):
            pre_carries = {"actor": a_carry, "critic": c_carry}
            action, a_carry, c_carry, noise_st = self._policy_step(
                nets, behavior, critic_params, obs, reset, a_carry, c_carry,
                noise_st, draws,
            )
            env_state, ts = self.env.step(env_state, action, draws)
            records.append(
                StepRecord(
                    obs=obs,
                    action=action,
                    reward=ts.reward,
                    discount=ts.discount,
                    reset=reset,
                    carries=pre_carries,
                )
            )
            obs, reset = ts.obs, ts.reset
        return self._absorb(state, records, env_state, obs, reset, a_carry,
                            c_carry, noise_st, local=nets is not None)

    def _absorb(
        self, state, records, env_state, obs, reset, a_carry, c_carry, noise_st,
        local: bool = False,
    ):
        """Fold one phase's ``stride`` step records into the state: the
        episode bookkeeping, the window shift and the counters.  A step's
        done flag is the next step's reset flag (``reset`` after the last).

        The finished-episode sums are summed over the mesh (``_psum``),
        unless ``local``: the pipelined collector keeps this rank's own sums
        and calls no collective (the learner thread sums them at its log
        fetch, ``training/pipeline.py``)."""
        psum = (lambda x: x) if local else self._psum
        ep_ret = state.episode_return
        comp_sum, comp_cnt = [], []
        dones = [r.reset for r in records[1:]] + [reset]
        for record, done in zip(records, dones):
            ep_ret = ep_ret + record.reward
            done = done > 0
            comp_sum.append(torch.where(done, ep_ret, 0.0).sum())
            comp_cnt.append(done.sum())
            ep_ret = torch.where(done, 0.0, ep_ret)
        cfg = self.config
        return dataclasses.replace(
            state,
            env_state=env_state,
            obs=obs,
            reset=reset,
            actor_carry=a_carry,
            critic_carry=c_carry,
            noise_state=noise_st,
            env_steps=state.env_steps + cfg.stride * self.global_envs,
            episode_return=ep_ret,
            completed_return_sum=state.completed_return_sum
            + psum(torch.stack(comp_sum).sum()),
            completed_count=state.completed_count
            + psum(torch.stack(comp_cnt).sum().to(torch.float32)),
            window=shift_in(state.window, stack_steps(records)),
            phase_idx=state.phase_idx + 1,
        )

    def _initial_priorities(self, train, arena, seq) -> torch.Tensor:
        """Entry priority for B fresh sequences: td | max | uniform ones."""
        cfg = self.config
        if cfg.initial_priority == "td" and cfg.prioritized:
            return self.agent.initial_priority(train, seq)
        if cfg.prioritized:
            return (self.arena.priority_max(arena).clamp_min(1.0)
                    .expand(cfg.num_envs).clone())
        return torch.ones(cfg.num_envs, device=self.device)

    def _emit_and_add(self, state: TrainerState) -> TrainerState:
        """Emit the window as one sequence per env and add with priority."""
        seq = emit(state.window)
        prios = self._initial_priorities(state.train, state.arena, seq)
        seq, prios = self._reshard_add(seq, prios)
        # The live nets collected this window: both meta columns carry the
        # current learner step (behaviour version and entry stamp coincide).
        meta = torch.full(
            (prios.shape[0], 2), state.train.step, dtype=torch.int32,
            device=self.device,
        )
        self.arena.add(state.arena, seq, prios, meta=meta)
        return state

    def _update_step(
        self, train, arena, res, normal=None
    ) -> Tuple[TrainState, ArenaState, Metrics]:
        """IS weights -> gradient update -> priority write-back on a sampled batch.

        ``normal`` is the target-policy smoothing draw (``None`` when off).
        """
        cfg = self.config
        self._updates += 1
        with span_id(self._updates):
            with annotate("learner/is_weights"):
                if cfg.prioritized:
                    beta = anneal_beta(train.step, beta0=cfg.beta0, steps=cfg.beta_steps)
                    w = importance_weights(res.probs, self.arena.size(arena), beta=beta)
                else:
                    w = torch.ones(cfg.batch_size, device=self.device)
                batch, w_local, normal = self._reshard_batch(res.batch, w, normal)
            train, prios, metrics = self.agent.learner_step(train, batch, w_local, normal)
            if cfg.prioritized:
                arena = self.arena.update_priorities(arena, res.indices, prios)
            with annotate("learner/quality"):
                # Experience-quality metrics: ESS fraction of the IS weights,
                # share of weights at the normalized ceiling, mean replay age
                # in learner steps.
                inv = 1.0 / res.probs.clamp_min(1e-12)
                metrics = dict(metrics)
                metrics["quality_ess_frac"] = inv.sum() ** 2 / (
                    res.probs.shape[0] * inv.square().sum()
                )
                metrics["quality_is_saturation"] = (w >= 1.0 - 1e-9).float().mean()
                entry = res.entry if res.entry is not None else arena.meta[res.indices, 1]
                armed = entry >= 0
                age = torch.where(armed, (train.step - entry).clamp_min(0), 0)
                metrics["quality_replay_age"] = (
                    age.sum().float() / armed.sum().clamp_min(1).float()
                )
        return train, arena, metrics

    def _sample(self, arena, draws):
        b = self.config.batch_size
        return self.arena.sample(arena, b, uniforms=draws.uniform((b,)))

    def _smoothing_normal(self, res, draws):
        """Step's target-policy smoothing normal, or None when it is off."""
        acfg = self.agent.config
        if acfg.target_policy_sigma <= 0:
            return None
        b, a_dim = res.batch.action.shape[0], res.batch.action.shape[-1]
        return draws.normal((acfg.unroll + acfg.n_step, b, a_dim))

    def _learn_step(self, train, arena, draws):
        """ONE learner update: sample -> IS weights -> update -> write-back."""
        res = self._sample(arena, draws)
        return self._update_step(train, arena, res, self._smoothing_normal(res, draws))

    def _learn_many(
        self, train, arena, draws, *, prefetch: bool = False
    ) -> Tuple[TrainState, ArenaState, Metrics]:
        """K learner updates; metrics are the mean over the K steps.

        ``prefetch=True`` double-buffers the batch (the pipelined drain):
        batch k+1 is drawn and gathered BEFORE update k and its priority
        write-back, so it is sampled against priorities one update stale.
        Unlike the JAX scan, no trailing batch is sampled after the last
        update.  With uniform replay both branches are the same updates.
        """
        k_steps = self.config.learner_steps
        steps = []
        if not prefetch:
            for _ in range(k_steps):
                train, arena, m = self._learn_step(train, arena, draws)
                steps.append(m)
        else:
            res = self._sample(arena, draws)
            for k in range(k_steps):
                nxt = self._sample(arena, draws) if k + 1 < k_steps else None
                normal = self._smoothing_normal(res, draws)
                train, arena, m = self._update_step(train, arena, res, normal)
                steps.append(m)
                res = nxt
        metrics = {k: torch.stack([m[k] for m in steps]).mean() for k in steps[0]}
        return train, arena, self._pmean(metrics)

    def _learn(self, state: TrainerState) -> Tuple[TrainerState, Metrics]:
        train, arena, metrics = self._learn_many(state.train, state.arena, state.draws)
        return dataclasses.replace(state, train=train, arena=arena), metrics

    # -------------------------------------------------------------- phases
    def collect_phase(self, state: TrainerState) -> TrainerState:
        return self._collect(state)

    def fill_phase(self, state: TrainerState) -> TrainerState:
        return self._emit_and_add(self._collect(state))

    def train_phase(self, state: TrainerState) -> Tuple[TrainerState, Metrics]:
        if self.config.param_sync_every > 0:
            # Persist the snapshot BEFORE collecting (phase_idx is still this
            # phase's index), so the params _collect acts with are carried
            # forward until the next sync phase.
            state = dataclasses.replace(
                state, behavior_params=self._behavior_params(state)
            )
        phase = state.phase_idx
        with annotate("trainer/collect", phase):
            state = self._collect(state)
        with annotate("trainer/emit_add", phase):
            state = self._emit_and_add(state)
        with annotate("trainer/learn", phase):
            return self._learn(state)

    # ------------------------------------------------------------ schedule
    @property
    def window_fill_phases(self) -> int:
        """Phases needed before the window holds seq_len real steps."""
        return -(-self.seq_len // self.config.stride)

    @property
    def replay_fill_phases(self) -> int:
        """Additional phases to reach min_replay sequences."""
        return -(-self.config.min_replay // self.config.num_envs)

    def pop_episode_metrics(
        self, state: TrainerState
    ) -> Tuple[TrainerState, Dict[str, float]]:
        """Drain the completed-episode accumulators (one host fetch, which
        also carries the arena's priority sum to its gauge and the values of
        ``_log_extra_refs``)."""
        extra = self._log_extra_refs(state.arena)
        fetched = torch.cat(
            [torch.stack([state.completed_count, state.completed_return_sum,
                          self.arena.priority_sum(state.arena)])]
            + [x.reshape(-1).to(torch.float32) for x in extra]
        ).tolist()
        count, ret_sum, psum = fetched[:3]
        if extra:
            tail, off = [], 3
            for x in extra:
                tail.append(fetched[off:off + x.numel()])
                off += x.numel()
            self._log_extra_publish(tail)
        metrics = {
            "episode_return_mean": ret_sum / max(count, 1.0),
            "episodes": count,
            "env_steps": float(state.env_steps),
        }
        self.arena.observe_state_scalars(
            float(self.arena.size(state.arena)), psum,
            float(state.arena.total_added),
        )
        self._obs_publish(metrics)
        zero = torch.zeros((), device=self.device)
        state = dataclasses.replace(
            state, completed_return_sum=zero, completed_count=zero.clone()
        )
        return state, metrics

    def _obs_publish(self, metrics: Dict[str, float], device: bool = True) -> None:
        """Fold one log cadence's host-side scalars onto the registry (the
        phase-locked and pipelined log paths share it).  ``device`` also
        publishes the device plane, whose MFU window runs from one device
        publish to the next: a cadence publishes it once."""
        if "env_steps" in metrics:
            self._obs_env_steps.set(metrics["env_steps"])
        if "episode_return_mean" in metrics:
            self._obs_return.set(metrics["episode_return_mean"])
        if "learner_steps" in metrics:
            self._obs_learner_steps.set(metrics["learner_steps"])
        if metrics.get("episodes"):
            self._obs_episodes.inc(metrics["episodes"])
        if any(k.startswith("quality_") for k in metrics):
            get_quality_plane().publish_scalars(
                ess_frac=metrics.get("quality_ess_frac"),
                is_saturation=metrics.get("quality_is_saturation"),
                replay_age_mean=metrics.get("quality_replay_age"),
            )
        if device:
            self._device.publish()

    # ----------------------------------------------------------- main loop
    def run(
        self,
        num_phases: int,
        state: Optional[TrainerState] = None,
        log_every: int = 50,
        log_fn=print,
        on_phase: Optional[
            Callable[[TrainerState, Optional[Dict[str, float]]], Optional[TrainerState]]
        ] = None,
        minutes: Optional[float] = None,
    ) -> TrainerState:
        """Drive the static phase schedule (warm-up -> fill -> train) from
        ``state.phase_idx`` (0 for a fresh state) up to phase ``num_phases``.

        Every ``log_every`` phases the episode metrics are drained and
        ``log_fn`` gets one line.  ``on_phase(state, scalars)`` runs after
        every phase: ``scalars`` holds what was logged (episode metrics and
        the last learner metrics) on a log phase, and is None otherwise; a
        state it returns replaces the run's.  ``minutes`` bounds the wall
        clock: no phase starts once it is spent, by rank 0's clock
        (``_agree``), so every rank of a mesh stops after the same phase.
        """
        state = self.init() if state is None else state
        deadline = time.monotonic() + minutes * 60 if minutes is not None else None
        warm, fill = self.window_fill_phases, self.replay_fill_phases
        last_metrics: Metrics = {}
        mon = self._device
        mon.begin_run()
        train_done = 0
        try:
            for phase in range(state.phase_idx, num_phases):
                if deadline is not None and self._agree(time.monotonic() >= deadline):
                    break
                if phase < warm:
                    with annotate("trainer/collect_phase"):
                        state = self.collect_phase(state)
                elif phase < warm + fill:
                    with annotate("trainer/fill_phase"):
                        state = self.fill_phase(state)
                else:
                    mon.on_phase(train_done + 1)
                    with annotate("trainer/train_phase"):
                        if train_done == 0:
                            # The MFU numerator: the first train phase runs
                            # under the FLOP counter (results unchanged).
                            (state, last_metrics), flops = count_flops(
                                self.train_phase, state)
                            mon.set_learn_cost(flops)
                        else:
                            state, last_metrics = self.train_phase(state)
                    mon.note_learn()
                    train_done += 1
                    if train_done == 1:
                        mon.mark_steady()
                scalars = None
                if log_every and (phase + 1) % log_every == 0:
                    state, scalars = self.pop_episode_metrics(state)
                    names = list(last_metrics)
                    values = (
                        torch.stack([last_metrics[k] for k in names]).tolist()
                        if names
                        else []
                    )
                    learn = dict(zip(names, values))
                    # pop_episode_metrics published the device plane.
                    self._obs_publish(
                        {"learner_steps": float(state.train.step), **learn},
                        device=False)
                    scalars.update(learn)
                    log_fn(
                        f"phase {phase + 1}/{num_phases} "
                        f"env_steps {int(scalars['env_steps'])} "
                        f"return {scalars['episode_return_mean']:.1f} "
                        f"({int(scalars['episodes'])} eps) "
                        + " ".join(f"{k} {v:.3g}" for k, v in zip(names, values))
                    )
                if on_phase is not None:
                    replaced = on_phase(state, scalars)
                    if replaced is not None:
                        state = replaced
        finally:
            mon.end_run()
        return state
