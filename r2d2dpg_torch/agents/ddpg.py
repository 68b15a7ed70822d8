"""R2D2-DPG learner: burn-in + n-step DDPG update on tensors.

Port of ``r2d2dpg_tpu/agents/ddpg.py``.  One ``learner_step``:

  no-grad burn-in of all four nets from the STORED recurrent state ->
  n-step targets through the target nets -> IS-weighted critic Huber loss ->
  actor loss ``-Q(s, mu(s))`` through the frozen online critic -> Adam with
  global-norm clipping -> Polyak target update -> eta-mix sequence priority.

The optimizer is written out as plain tensor functions that reproduce
``optax.chain(optax.clip_by_global_norm(c), optax.adam(lr))`` exactly:
the clip scales by ``c / g_norm`` only when ``g_norm >= c`` (torch's
``clip_grad_norm_`` adds 1e-6 to the norm, which is not the same), and Adam
adds ``eps`` outside the square root.

The JAX ``vmap`` over stacked parameters (fused burn-in, twin critics)
becomes a leading ensemble axis on the parameter tensors; the nets' matmuls
and grouped convolutions broadcast over it.

The TD3 knobs, both off by default (the off path is the plain DDPG step
above, unchanged):

- ``twin_critic``: two critics, independently initialized and stacked on a
  leading ``[2]`` axis of every critic tensor.  Targets bootstrap from
  ``min(Q1', Q2')``, both members train against them (losses summed), the
  actor ascends member 0, priorities and ``q_mean`` come from member 0, and
  collection advances the critic carry with member 0
  (``behavior_critic_params``).
- ``target_policy_sigma``: TD3 target-policy smoothing.  The bootstrap
  action gets ``clip(sigma * N(0, 1), ±target_policy_clip)`` noise.  The
  standard normal ``[U + n, B, A]`` (time-major) is an argument of
  ``learner_step``, so a test can hand the port the JAX package's draw.

Data parallelism: ``axis_name`` (``"dp"``) makes ``learner_step`` average
the critic and actor gradients over the agent's ``mesh``
(``parallel/mesh.py``) before the clip and Adam, where the JAX step calls
``lax.pmean``.  Each net's gradients travel as one flattened buffer, so a
step costs two collectives.

``learner_step``'s parts are sibling spans (``utils/profiling.py``):
``learner/burn_in``, ``learner/targets``, ``learner/critic_forward``,
``learner/critic_backward``, ``learner/actor_forward``,
``learner/actor_backward``, ``learner/optimize`` (clip, both Adams, both
Polyaks) and ``learner/priorities`` (priorities and the metrics).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from r2d2dpg_torch.device import DeviceLike
from r2d2dpg_torch.models.actor_critic import (
    ActorNet,
    Carry,
    CriticNet,
    Params,
    time_major,
    unroll,
)
from r2d2dpg_torch.ops import (
    huber,
    n_step_targets,
    polyak_update,
    sequence_priority,
    td_errors,
)
from r2d2dpg_torch.replay.arena import SequenceBatch
from r2d2dpg_torch.tree import tree_map
from r2d2dpg_torch.utils.profiling import annotate


@dataclasses.dataclass(frozen=True)
class AdamState:
    """``optax.scale_by_adam`` state: step count and the two moments."""

    count: int
    mu: Params
    nu: Params


@dataclasses.dataclass(frozen=True)
class TrainState:
    """All learner-owned state.  Updates build new tensors, never mutate."""

    actor_params: Params
    critic_params: Params
    target_actor_params: Params
    target_critic_params: Params
    actor_opt_state: AdamState
    critic_opt_state: AdamState
    step: int


@dataclasses.dataclass(frozen=True)
class AgentConfig:
    """Static hyperparameters (same fields and defaults as the JAX package)."""

    burnin: int = 20
    unroll: int = 20
    n_step: int = 5
    gamma: float = 0.99
    tau: float = 5e-3
    eta: float = 0.9
    actor_lr: float = 1e-4
    critic_lr: float = 1e-3
    use_huber: bool = True
    grad_clip: Optional[float] = 40.0
    axis_name: Optional[str] = None  # mesh axis for gradient sync (data parallel)
    # Burn online+target nets together on a stacked [2] ensemble axis.
    fused_burnin: bool = True
    twin_critic: bool = False
    target_policy_sigma: float = 0.0
    target_policy_clip: float = 0.5

    @property
    def seq_len(self) -> int:
        """Stored sequence length: burn-in + unroll + n-step bootstrap tail."""
        return self.burnin + self.unroll + self.n_step


# ----------------------------------------------------------------- optimizer
def global_norm(*trees: Params) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of squares over all leaves."""
    return torch.sqrt(sum((x * x).sum() for tree in trees for x in tree.values()))


def clip_by_global_norm(grads: Params, max_norm: float) -> Params:
    """``optax.clip_by_global_norm``: ``t / g * max_norm`` iff ``g >= max_norm``."""
    g = global_norm(grads)
    keep = g < max_norm
    return {k: torch.where(keep, t, (t / g) * max_norm) for k, t in grads.items()}


def adam_init(params: Params) -> AdamState:
    return AdamState(
        count=0,
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
    )


def adam_step(
    params: Params,
    grads: Params,
    state: AdamState,
    *,
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> Tuple[Params, AdamState]:
    """``optax.adam`` + ``apply_updates``: returns (new params, new state)."""
    count = state.count + 1
    # Bias corrections in float32, as optax computes ``1 - decay**count``.
    bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
    bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
    mu, nu, new = {}, {}, {}
    for k, g in grads.items():
        mu[k] = (1 - b1) * g + b1 * state.mu[k]
        nu[k] = (1 - b2) * (g * g) + b2 * state.nu[k]
        update = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
        new[k] = params[k] + (-lr) * update
    return new, AdamState(count=count, mu=mu, nu=nu)


# ----------------------------------------------------------- ensemble helpers
def _stack2(a: Params, b: Params) -> Params:
    return {k: torch.stack([a[k], b[k]]) for k in a}


def _stack_n(carry: Carry, n: int) -> Carry:
    return tuple(torch.stack([x] * n) for x in carry)


def _concat(a: Params, b: Params) -> Params:
    return {k: torch.cat([a[k], b[k]]) for k in a}


def _unstack2(carry: Carry) -> Tuple[Carry, Carry]:
    return tuple(x[0] for x in carry), tuple(x[1] for x in carry)


def _split_at(carry: Carry, n: int) -> Tuple[Carry, Carry]:
    return tuple(x[:n] for x in carry), tuple(x[n:] for x in carry)


def _member(tree, i: int):
    """Member ``i`` of ensemble-stacked params or carry."""
    return tree_map(lambda x: x[i], tree)


def _leaf_params(params: Params) -> Params:
    """Fresh autograd leaves over ``params`` (gradient targets)."""
    return {k: v.detach().requires_grad_(True) for k, v in params.items()}


class R2D2DPG:
    """Agent: networks + optimizer config + the learner step."""

    def __init__(self, actor: ActorNet, critic: CriticNet, config: AgentConfig):
        self.actor = actor
        self.critic = critic
        self.config = config
        # The group ``config.axis_name`` averages gradients over; a
        # data-parallel trainer binds it (``bind_mesh``).
        self.mesh = None

    def bind_mesh(self, mesh, axis_name: Optional[str] = None) -> "R2D2DPG":
        """A copy of this agent (same modules) that averages its gradients
        over ``mesh``; ``axis_name`` replaces the config's when given."""
        cfg = self.config
        if axis_name is not None and axis_name != cfg.axis_name:
            cfg = dataclasses.replace(cfg, axis_name=axis_name)
        if cfg.axis_name is None:
            raise ValueError("bind_mesh: the agent has no axis_name to sync over")
        agent = R2D2DPG(self.actor, self.critic, cfg)
        agent.mesh = mesh
        return agent

    def _pmean_grads(self, grads: Params) -> Params:
        """``lax.pmean`` of one net's gradients: one flattened buffer, one
        collective, split back into the leaves."""
        if self.mesh is None:
            raise ValueError(
                f"AgentConfig.axis_name={self.config.axis_name!r} needs a mesh "
                "(R2D2DPG.bind_mesh) to sync gradients over"
            )
        keys = list(grads)
        flat = torch.cat([grads[k].reshape(-1) for k in keys])
        self.mesh.pmean_(flat)
        out, off = {}, 0
        for k in keys:
            n = grads[k].numel()
            out[k] = flat[off:off + n].view_as(grads[k])
            off += n
        return out

    # ------------------------------------------------------------------ init
    def init(
        self, generator: Optional[torch.Generator], device: DeviceLike = None
    ) -> TrainState:
        """Fresh params (targets as copies) and zero Adam states on ``device``
        (``cuda`` unless the caller names another).  Twin critics are two
        independent inits stacked on a leading ``[2]`` axis."""
        actor_params = self.actor.init_params(generator, device)
        critic_params = self.critic.init_params(generator, device)
        if self.config.twin_critic:
            critic_params = _stack2(
                critic_params, self.critic.init_params(generator, device)
            )
        copy = lambda p: {k: v.clone() for k, v in p.items()}  # noqa: E731
        return TrainState(
            actor_params=actor_params,
            critic_params=critic_params,
            target_actor_params=copy(actor_params),
            target_critic_params=copy(critic_params),
            actor_opt_state=adam_init(actor_params),
            critic_opt_state=adam_init(critic_params),
            step=0,
        )

    # --------------------------------------------------------------- unrolls
    def _unroll_actor(self, params, carry, obs_tm, reset_tm):
        return unroll(
            lambda c, o, r: self.actor.apply_params(params, o, c, r),
            carry,
            obs_tm,
            reset_tm,
        )

    def _unroll_critic(self, params, carry, obs_tm, act_tm, reset_tm):
        return unroll(
            lambda c, o, a, r: self.critic.apply_params(params, o, a, c, r),
            carry,
            obs_tm,
            act_tm,
            reset_tm,
        )

    def _unroll_pi_q(self, actor_params, critic_params, ca, cc, obs_tm, reset_tm):
        """Actor and critic advanced together: a_t = mu(o_t), q_t = Q(o_t, a_t)."""

        def step(carry, o, r):
            ca, cc = carry
            a, ca = self.actor.apply_params(actor_params, o, ca, r)
            q, cc = self.critic.apply_params(critic_params, o, a, cc, r)
            return (a, q), (ca, cc)

        (a_tm, q_tm), carry = unroll(step, (ca, cc), obs_tm, reset_tm)
        return a_tm, q_tm, carry

    def behavior_critic_params(self, state: TrainState) -> Params:
        """Critic params for the collection-time carry advance: member 0 in
        twin mode (the stored carry seeds both members at burn-in)."""
        if self.config.twin_critic:
            return _member(state.critic_params, 0)
        return state.critic_params

    def _apply_critic_ens(self, params, o, a, carry, r):
        """One critic forward, min-reduced over the ensemble when twin."""
        q, carry = self.critic.apply_params(params, o, a, carry, r)
        return (q.amin(0) if self.config.twin_critic else q), carry

    def _target_q(self, state, ca_tg, cc_tg, obs_tm, reset_tm, eps_tm=None):
        """Bootstrap Q through the target nets, time-major ``[T, B]``.

        Actor and critic advance together; the action is smoothed with the
        clipped noise ``eps_tm`` when given, and Q is the min over the twin
        target critics in twin mode.
        """
        ap, cp = state.target_actor_params, state.target_critic_params

        def step(carry, o, r, *e):
            ca, cc = carry
            a, ca = self.actor.apply_params(ap, o, ca, r)
            if e:
                a = (a + e[0]).clamp(-1.0, 1.0)
            q, cc = self._apply_critic_ens(cp, o, a, cc, r)
            return q, (ca, cc)

        xs = (obs_tm, reset_tm) + (() if eps_tm is None else (eps_tm,))
        q_tm, _ = unroll(step, (ca_tg, cc_tg), *xs)
        return q_tm

    @torch.no_grad()
    def _burn_in(
        self, state: TrainState, batch: SequenceBatch
    ) -> Tuple[Carry, Carry, Carry, Carry]:
        """Warm all four nets' carries over the burn-in prefix, no gradient.

        With twin critics the stored critic carry seeds BOTH members, and
        the critic carries come back stacked ``[2, B, H]``.
        """
        cfg = self.config
        twin = cfg.twin_critic
        nq = 2 if twin else 1
        ca0, cc0 = batch.carries["actor"], batch.carries["critic"]
        cc0e = _stack_n(cc0, nq) if twin else cc0
        if cfg.burnin == 0 or not (self.actor.use_lstm or self.critic.use_lstm):
            return ca0, ca0, cc0e, cc0e
        obs_b = time_major(batch.obs[:, : cfg.burnin])
        act_b = time_major(batch.action[:, : cfg.burnin])
        reset_b = time_major(batch.reset[:, : cfg.burnin])
        ca_on = ca_tg = ca0
        cc_on = cc_tg = cc0e
        if cfg.fused_burnin:
            # One unroll per net: online and target params stacked on a
            # leading axis ([2], or [4] with twin critics), final carry kept.
            if self.actor.use_lstm:
                p2 = _stack2(state.actor_params, state.target_actor_params)
                _, c2 = self._unroll_actor(p2, _stack_n(ca0, 2), obs_b, reset_b)
                ca_on, ca_tg = _unstack2(c2)
            if self.critic.use_lstm:
                on, tg = state.critic_params, state.target_critic_params
                p_all = _concat(on, tg) if twin else _stack2(on, tg)
                _, c_all = self._unroll_critic(
                    p_all, _stack_n(cc0, 2 * nq), obs_b, act_b, reset_b
                )
                cc_on, cc_tg = _split_at(c_all, nq) if twin else _unstack2(c_all)
        else:
            if self.actor.use_lstm:
                _, ca_on = self._unroll_actor(state.actor_params, ca0, obs_b, reset_b)
                _, ca_tg = self._unroll_actor(
                    state.target_actor_params, ca0, obs_b, reset_b
                )
            if self.critic.use_lstm:
                _, cc_on = self._unroll_critic(
                    state.critic_params, cc0e, obs_b, act_b, reset_b
                )
                _, cc_tg = self._unroll_critic(
                    state.target_critic_params, cc0e, obs_b, act_b, reset_b
                )
        return ca_on, ca_tg, cc_on, cc_tg

    def _window(self, batch: SequenceBatch):
        """Time-major obs/action/reset of the window [burnin, seq_len)."""
        w = slice(self.config.burnin, self.config.seq_len)
        return (
            time_major(batch.obs[:, w]),
            time_major(batch.action[:, w]),
            time_major(batch.reset[:, w]),
        )

    @torch.no_grad()
    def _targets(self, state, batch, ca_tg, cc_tg, obs_w, reset_w, eps_w=None):
        """n-step targets ``[B, U]`` through the target nets."""
        cfg = self.config
        w = slice(cfg.burnin, cfg.seq_len)
        q_tg_tm = self._target_q(state, ca_tg, cc_tg, obs_w, reset_w, eps_w)
        return n_step_targets(
            batch.reward[:, w],
            batch.discount[:, w],
            batch.reset[:, w],
            time_major(q_tg_tm),
            n=cfg.n_step,
            gamma=cfg.gamma,
        )

    # ---------------------------------------------------------- learner step
    def learner_step(
        self,
        state: TrainState,
        batch: SequenceBatch,
        is_weights: torch.Tensor,
        normal: Optional[torch.Tensor] = None,
    ) -> Tuple[TrainState, torch.Tensor, Dict[str, torch.Tensor]]:
        """One optimization step on a batch of sequences ``[B, L, ...]``.

        ``normal`` is the standard normal ``[U + n, B, A]`` of the target-policy
        smoothing; required iff ``config.target_policy_sigma > 0``.

        Returns (new_state, new_priorities ``[B]``, metrics of 0-dim tensors).
        """
        cfg = self.config
        U = cfg.unroll
        twin = cfg.twin_critic
        with annotate("learner/burn_in"):
            ca_on, ca_tg, cc_on, cc_tg = self._burn_in(state, batch)
        with annotate("learner/targets"):
            obs_w, act_w, reset_w = self._window(batch)
            eps_w = None
            if cfg.target_policy_sigma > 0:
                if normal is None or normal.shape != act_w.shape:
                    raise ValueError(
                        "AgentConfig.target_policy_sigma > 0 requires "
                        f"learner_step(..., normal=<standard normal {tuple(act_w.shape)}>)"
                    )
                eps_w = (cfg.target_policy_sigma * normal).clamp(
                    -cfg.target_policy_clip, cfg.target_policy_clip
                )
            y = self._targets(state, batch, ca_tg, cc_tg, obs_w, reset_w, eps_w)  # [B, U]
        # Online unrolls need only the U training steps.
        obs_u, act_u, reset_u = obs_w[:U], act_w[:U], reset_w[:U]

        with torch.enable_grad():
            # --- critic update (IS-weighted).  Twin mode trains both members
            # against the same min-bootstrapped y, losses SUMMED (TD3's
            # L1 + L2: each member gets the gradient it would get alone).
            with annotate("learner/critic_forward"):
                cp = _leaf_params(state.critic_params)
                q_tm, _ = self._unroll_critic(cp, cc_on, obs_u, act_u, reset_u)
                if twin:
                    q2 = q_tm.permute(1, 2, 0)  # [U, 2, B] -> [2, B, U]
                    td2 = td_errors(q2, y)
                    per_step = huber(td2) if cfg.use_huber else 0.5 * td2**2
                    critic_loss = (is_weights[:, None] * per_step.sum(0)).mean()
                    q_spread = (q2[0] - q2[1]).abs().mean()
                    q, td = q2[0], td2[0]
                else:
                    q = time_major(q_tm)  # [B, U]
                    td = td_errors(q, y)
                    per_step = huber(td) if cfg.use_huber else 0.5 * td**2
                    critic_loss = (is_weights[:, None] * per_step).mean()
            with annotate("learner/critic_backward"):
                critic_grads = dict(
                    zip(cp, torch.autograd.grad(critic_loss, list(cp.values())))
                )

            # --- actor update: -Q(s, mu(s)) through the frozen online critic
            # (member 0 in twin mode, the TD3 convention).
            with annotate("learner/actor_forward"):
                ap = _leaf_params(state.actor_params)
                _, q_pi_tm, _ = self._unroll_pi_q(
                    ap,
                    self.behavior_critic_params(state),
                    ca_on,
                    _member(cc_on, 0) if twin else cc_on,
                    obs_u,
                    reset_u,
                )
                actor_loss = -q_pi_tm.mean()
            with annotate("learner/actor_backward"):
                actor_grads = dict(
                    zip(ap, torch.autograd.grad(actor_loss, list(ap.values())))
                )

        with torch.no_grad():
            if cfg.axis_name is not None:
                # Gradient sync over the mesh, before the clip and Adam.
                critic_grads = self._pmean_grads(critic_grads)
                actor_grads = self._pmean_grads(actor_grads)
            with annotate("learner/optimize"):
                critic_params, critic_opt_state = self._optimize(
                    state.critic_params, critic_grads, state.critic_opt_state,
                    cfg.critic_lr,
                )
                actor_params, actor_opt_state = self._optimize(
                    state.actor_params, actor_grads, state.actor_opt_state, cfg.actor_lr
                )
                new_state = TrainState(
                    actor_params=actor_params,
                    critic_params=critic_params,
                    target_actor_params=polyak_update(
                        actor_params, state.target_actor_params, cfg.tau
                    ),
                    target_critic_params=polyak_update(
                        critic_params, state.target_critic_params, cfg.tau
                    ),
                    actor_opt_state=actor_opt_state,
                    critic_opt_state=critic_opt_state,
                    step=state.step + 1,
                )
            with annotate("learner/priorities"):
                td = td.detach()
                q = q.detach()
                priorities = sequence_priority(td, eta=cfg.eta)
                metrics = {
                    "critic_loss": critic_loss.detach(),
                    "actor_loss": actor_loss.detach(),
                    "q_mean": q.mean(),
                    "td_abs_mean": td.abs().mean(),
                    "target_mean": y.mean(),
                    "grad_norm": global_norm(actor_grads, critic_grads),
                    "param_norm": global_norm(actor_params, critic_params),
                }
                if twin:
                    metrics["q_spread"] = q_spread.detach()  # |Q1 - Q2|
        return new_state, priorities, metrics

    def _optimize(self, params, grads, opt_state, lr):
        if self.config.grad_clip is not None:
            grads = clip_by_global_norm(grads, self.config.grad_clip)
        return adam_step(params, grads, opt_state, lr=lr)

    # ------------------------------------------------------- initial priority
    @torch.no_grad()
    def initial_priority(
        self, state: TrainState, batch: SequenceBatch
    ) -> torch.Tensor:
        """TD-error priority for fresh sequences at collection time.

        Same bootstrap as the learner (ensemble min in twin mode), no
        smoothing noise; Q from member 0 in twin mode.
        """
        cfg = self.config
        ca_on, ca_tg, cc_on, cc_tg = self._burn_in(state, batch)
        obs_w, act_w, reset_w = self._window(batch)
        y = self._targets(state, batch, ca_tg, cc_tg, obs_w, reset_w)
        U = cfg.unroll
        q_tm, _ = self._unroll_critic(
            self.behavior_critic_params(state),
            _member(cc_on, 0) if cfg.twin_critic else cc_on,
            obs_w[:U],
            act_w[:U],
            reset_w[:U],
        )
        return sequence_priority(td_errors(time_major(q_tm), y), eta=cfg.eta)
