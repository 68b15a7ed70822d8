"""Plain R2D2-DPG learner update, prioritized sampling and write-back.

One update, written from the recipe: burn-in of the online and target
nets from the stored carries (no gradient); n-step targets through the
target actor and critic over the window ``[burnin, burnin + U + n)``;
the IS-weighted Huber critic loss over the first ``U`` steps; the actor
loss ``-mean Q(s, mu(s))`` through the online critic as it was before this
update; per net, clip by global norm (scale by ``c / g`` when ``g >= c``)
and Adam (``eps`` outside the root, bias corrections in float32); Polyak
targets; the sequence priority ``eta max|td| + (1 - eta) mean|td| + 1e-6``.
The one-step nets are the model entry's ``NETS`` (``LearnerState.nets``;
the LSTM's of ``nets.py`` by default), so that any core whose carry the
arena stores per sequence runs the same update.

Sampling is proportional to ``p ** alpha`` by inverse CDF over the
uniforms the benchmark drew; IS weights are ``(N P(i)) ** -beta`` over
their batch maximum, with beta annealed linearly from ``beta0`` to 1.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from perfbench.reference import nets as lstm_nets
from perfbench.reference.nets import Params, Precision

PRIORITY_EPS = 1e-6


@dataclasses.dataclass
class Adam:
    count: int
    mu: Params
    nu: Params


@dataclasses.dataclass
class LearnerState:
    actor: Params
    critic: Params
    target_actor: Params
    target_critic: Params
    adam_actor: Adam
    adam_critic: Adam
    step: int = 0
    nets: Any = lstm_nets  # the model entry's NETS: actor_step, critic_step


def fresh_state(actor: Params, critic: Params, nets: Any = lstm_nets) -> LearnerState:
    zeros = lambda p: {k: torch.zeros_like(v) for k, v in p.items()}  # noqa: E731
    copy = lambda p: {k: v.clone() for k, v in p.items()}  # noqa: E731
    return LearnerState(copy(actor), copy(critic), copy(actor), copy(critic),
                        Adam(0, zeros(actor), zeros(actor)),
                        Adam(0, zeros(critic), zeros(critic)), nets=nets)


# ------------------------------------------------------------------ replay
def anneal_beta(step: int, beta0: float, steps: int) -> float:
    frac = min(max(np.float32(step) / np.float32(max(steps, 1)), 0.0), 1.0)
    return float(np.float32(beta0) + np.float32(1.0 - beta0) * np.float32(frac))


def sample(priority: torch.Tensor, uniforms: torch.Tensor, alpha: float):
    """``(indices, probs, cdf, total)`` of a proportional draw."""
    scaled = torch.where(priority > 0, priority ** alpha, torch.zeros_like(priority))
    total = scaled.sum()
    cdf = torch.cumsum(scaled, 0)
    idx = torch.searchsorted(cdf, uniforms * total, right=True).clamp(0, priority.numel() - 1)
    return idx, scaled[idx] / total, cdf, total, scaled


def index_misses(program_idx: torch.Tensor, uniforms, cdf, total, scaled,
                 rel_tol: float = 1e-6) -> int:
    """Program indices that the reference's CDF does not bear out: slot ``i``
    is right for ``v = u * total`` when ``cdf[i-1] <= v < cdf[i]``, each side
    widened by ``rel_tol * total`` (two sums of one vector in another order
    may place a draw within rounding of a boundary in either slot).  A
    program that sampled another number of indices than there are draws
    misses every draw."""
    if program_idx.shape != uniforms.shape:
        return int(uniforms.numel())
    i = program_idx.long().to(uniforms.device)
    v = uniforms * total
    tol = rel_tol * total
    lo = torch.where(i > 0, cdf[(i - 1).clamp_min(0)], torch.zeros_like(v))
    ok = (i >= 0) & (i < cdf.numel()) & (lo - tol <= v) & (v < cdf[i.clamp(0, cdf.numel() - 1)] + tol)
    ok &= scaled[i.clamp(0, cdf.numel() - 1)] > 0
    return int((~ok).sum())


def is_weights(probs: torch.Tensor, size: int, beta: float) -> torch.Tensor:
    w = (max(float(size), 1.0) * probs.clamp_min(1e-12)) ** (-beta)
    return w / w.max().clamp_min(1e-12)


def write_back(priority: torch.Tensor, indices: torch.Tensor, values: torch.Tensor) -> None:
    """``priority[indices[j]] = max(values[j], eps)`` in order: the last write wins."""
    values = values.clamp_min(PRIORITY_EPS)
    for j, i in enumerate(indices.tolist()):
        priority[i] = values[j]


# ------------------------------------------------------------------ targets
def n_step_targets(reward, discount, reset, q, n: int, gamma: float):
    """``[B, U]`` targets from ``[B, U + n]`` inputs.  A termination
    (``discount == 0``) keeps its reward and cuts what follows; a truncation
    (the next step starts an episode while ``discount > 0``) ends the
    horizon before that step's reward and bootstraps from the Q before it."""
    u = reward.shape[1] - n
    y = q[:, :u].clone()
    acc = torch.zeros_like(y)
    cont = torch.ones_like(y)
    live = torch.ones_like(y, dtype=torch.bool)
    for k in range(n):
        r, d = reward[:, k:k + u], discount[:, k:k + u]
        nxt = reset[:, k + 1:k + 1 + u] > 0
        take = live & ~(nxt & (d > 0))
        acc = torch.where(take, acc + gamma ** k * cont * r, acc)
        cont = torch.where(take, cont * d, cont)
        y = torch.where(take, acc + gamma ** (k + 1) * cont * q[:, k + 1:k + 1 + u], y)
        live = live & ~nxt
    return y


def huber(x):
    a = x.abs()
    quad = a.clamp(max=1.0)
    return 0.5 * quad ** 2 + (a - quad)


# ------------------------------------------------------------------ unrolls
def unroll_actor(nets, p, carry, obs, reset, pr):
    """Actor over ``[B, T, ...]``: ``(actions [B, T, A], carry)``."""
    out = []
    for s in range(obs.shape[1]):
        a, carry = nets.actor_step(p, obs[:, s], carry, reset[:, s], pr)
        out.append(a)
    return torch.stack(out, 1), carry


def unroll_critic(nets, p, carry, obs, action, reset, pr):
    """Critic over ``[B, T, ...]`` with given actions: ``(q [B, T], carry)``."""
    out = []
    for s in range(obs.shape[1]):
        q, carry = nets.critic_step(p, obs[:, s], action[:, s], carry, reset[:, s], pr)
        out.append(q)
    return torch.stack(out, 1), carry


def unroll_pi_q(nets, pa, pc, ca, cc, obs, reset, pr):
    """Actor and critic together, ``q_t = Q(o_t, mu(o_t))``: ``q [B, T]``."""
    out = []
    for s in range(obs.shape[1]):
        a, ca = nets.actor_step(pa, obs[:, s], ca, reset[:, s], pr)
        q, cc = nets.critic_step(pc, obs[:, s], a, cc, reset[:, s], pr)
        out.append(q)
    return torch.stack(out, 1), (ca, cc)


# ------------------------------------------------------------------ update
@dataclasses.dataclass
class HP:
    """The learner's hyperparameters (a configuration file's ``agent``)."""

    burnin: int
    unroll: int
    n_step: int
    gamma: float
    tau: float
    eta: float
    actor_lr: float
    critic_lr: float
    grad_clip: float


def _global_norm(g: Params):
    return torch.sqrt(sum((x * x).sum() for x in g.values()))


def _clip(g: Params, c: float) -> Params:
    n = _global_norm(g)
    return {k: torch.where(n < c, v, (v / n) * c) for k, v in g.items()}


def _adam(p: Params, g: Params, st: Adam, lr: float, b1=0.9, b2=0.999, eps=1e-8):
    count = st.count + 1
    bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
    bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
    mu = {k: (1 - b1) * g[k] + b1 * st.mu[k] for k in p}
    nu = {k: (1 - b2) * (g[k] * g[k]) + b2 * st.nu[k] for k in p}
    new = {k: p[k] + (-lr) * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)) for k in p}
    return new, Adam(count, mu, nu)


def burn_in(st: LearnerState, hp: HP, batch: Dict, pr: Precision):
    """Final carries ``(actor online, actor target, critic online, critic
    target)`` after the burn-in prefix; the stored carries when it is 0."""
    ca0, cc0 = batch["carry_actor"], batch["carry_critic"]
    if hp.burnin == 0:
        return ca0, ca0, cc0, cc0
    sl = slice(0, hp.burnin)
    obs, act, rst = batch["obs"][:, sl], batch["action"][:, sl], batch["reset"][:, sl]
    with torch.no_grad():
        _, ca_on = unroll_actor(st.nets, st.actor, ca0, obs, rst, pr)
        _, ca_tg = unroll_actor(st.nets, st.target_actor, ca0, obs, rst, pr)
        _, cc_on = unroll_critic(st.nets, st.critic, cc0, obs, act, rst, pr)
        _, cc_tg = unroll_critic(st.nets, st.target_critic, cc0, obs, act, rst, pr)
    return ca_on, ca_tg, cc_on, cc_tg


def targets(st: LearnerState, hp: HP, batch: Dict, ca_tg, cc_tg, pr: Precision):
    w = slice(hp.burnin, hp.burnin + hp.unroll + hp.n_step)
    with torch.no_grad():
        q_tg, _ = unroll_pi_q(st.nets, st.target_actor, st.target_critic, ca_tg, cc_tg,
                              batch["obs"][:, w], batch["reset"][:, w], pr)
        return n_step_targets(batch["reward"][:, w], batch["discount"][:, w],
                              batch["reset"][:, w], q_tg, hp.n_step, hp.gamma)


def priorities(td: torch.Tensor, eta: float) -> torch.Tensor:
    a = td.abs()
    return eta * a.amax(1) + (1 - eta) * a.mean(1) + PRIORITY_EPS


def update(st: LearnerState, hp: HP, batch: Dict, weights: torch.Tensor,
           pr: Precision, rows: Optional[int] = None):
    """One learner update.  Returns ``(new state, priorities [B], losses,
    clipped gradients)``; the losses are ``(critic, actor)`` floats.

    ``rows`` keeps only the first ``rows`` of the batch (a planted fault of
    the correctness check: part of the batch left out, the mean over the
    rest)."""
    if rows is not None:
        batch = {k: (tuple(c[:rows] for c in v) if isinstance(v, tuple) else v[:rows])
                 for k, v in batch.items()}
        weights = weights[:rows]
    u = hp.unroll
    ca_on, ca_tg, cc_on, cc_tg = burn_in(st, hp, batch, pr)
    y = targets(st, hp, batch, ca_tg, cc_tg, pr)
    w = slice(hp.burnin, hp.burnin + u)
    obs, act, rst = batch["obs"][:, w], batch["action"][:, w], batch["reset"][:, w]

    cp = {k: v.detach().requires_grad_(True) for k, v in st.critic.items()}
    q, _ = unroll_critic(st.nets, cp, cc_on, obs, act, rst, pr)
    td = y - q
    critic_loss = (weights[:, None] * huber(td)).mean()
    g_critic = dict(zip(cp, torch.autograd.grad(critic_loss, list(cp.values()))))

    ap = {k: v.detach().requires_grad_(True) for k, v in st.actor.items()}
    q_pi, _ = unroll_pi_q(st.nets, ap, st.critic, ca_on, cc_on, obs, rst, pr)
    actor_loss = -q_pi.mean()
    g_actor = dict(zip(ap, torch.autograd.grad(actor_loss, list(ap.values()))))

    with torch.no_grad():
        g_critic = _clip(g_critic, hp.grad_clip)
        g_actor = _clip(g_actor, hp.grad_clip)
        critic, adam_c = _adam(st.critic, g_critic, st.adam_critic, hp.critic_lr)
        actor, adam_a = _adam(st.actor, g_actor, st.adam_actor, hp.actor_lr)
        polyak = lambda new, old: {k: hp.tau * new[k] + (1 - hp.tau) * old[k] for k in old}  # noqa: E731
        new = LearnerState(actor, critic, polyak(actor, st.target_actor),
                           polyak(critic, st.target_critic), adam_a, adam_c, st.step + 1,
                           st.nets)
        prio = priorities(td.detach(), hp.eta)
    losses = (critic_loss.item(), actor_loss.item())
    return new, prio, losses, {"actor": g_actor, "critic": g_critic}


@torch.no_grad()
def initial_priority(st: LearnerState, hp: HP, batch: Dict, pr: Precision) -> torch.Tensor:
    """Entry priority of fresh sequences: the learner's TD priority with the
    current nets, no gradient."""
    ca_on, ca_tg, cc_on, cc_tg = burn_in(st, hp, batch, pr)
    y = targets(st, hp, batch, ca_tg, cc_tg, pr)
    w = slice(hp.burnin, hp.burnin + hp.unroll)
    q, _ = unroll_critic(st.nets, st.critic, cc_on, batch["obs"][:, w], batch["action"][:, w],
                         batch["reset"][:, w], pr)
    return priorities(y - q, hp.eta)


@torch.no_grad()
def exact_priority(st: LearnerState, hp: HP, batch: Dict) -> torch.Tensor:
    """``initial_priority`` recomputed in float64 from the same nets and
    batch: what a float32 priority is judged against, so that a sound
    program reads its own rounding whatever order it sums in."""
    d = lambda p: {k: v.double() for k, v in p.items()}  # noqa: E731
    st64 = dataclasses.replace(st, actor=d(st.actor), critic=d(st.critic),
                               target_actor=d(st.target_actor),
                               target_critic=d(st.target_critic))
    batch64 = {k: (tuple(c.double() for c in v) if isinstance(v, tuple)
                   else v if v.dtype == torch.uint8 else v.double())
               for k, v in batch.items()}
    return initial_priority(st64, hp, batch64, Precision("float32"))


def follow(st: LearnerState, hp: HP, arena: Dict, priority: torch.Tensor,
           draws: List[torch.Tensor], program_idx: List[torch.Tensor], size: int,
           alpha: float, beta0: float, beta_steps: int, pr: Precision,
           rows: Optional[int] = None, exact: Optional[torch.Tensor] = None):
    """The reference's own learner steps over ``arena`` (leaves ``[C, ...]``)
    from ``priority``, one per uniform draw in ``draws``, written back into
    ``priority`` in place (and, recomputed by ``exact_priority``, into the
    float64 ``exact`` when it is given).  A program index within rounding of
    the reference's draw (``index_misses``) is taken as the sample; each miss
    is counted and the reference's own index used.

    Returns ``(state, losses per step, indices per step, misses)``."""
    losses: List[Tuple[float, float]] = []
    used: List[torch.Tensor] = []
    misses = 0
    for k, u in enumerate(draws):
        idx, _, cdf, total, scaled = sample(priority, u, alpha)
        if program_idx is not None:
            bad = index_misses(program_idx[k], u, cdf, total, scaled)
            misses += bad
            if bad == 0:
                idx = program_idx[k].to(idx.device).long()
        probs = scaled[idx] / total
        beta = anneal_beta(st.step, beta0, beta_steps)
        w = is_weights(probs, size, beta)
        batch = gather(arena, idx)
        if exact is not None:
            kept = batch if rows is None else gather(batch, slice(0, rows))
            write_back(exact, idx[:rows], exact_priority(st, hp, kept))
        st, prio, loss, _ = update(st, hp, batch, w, pr, rows=rows)
        if rows is not None:
            idx = idx[:rows]
        write_back(priority, idx, prio)
        losses.append(loss)
        used.append(idx)
    return st, losses, used, misses


def gather(arena: Dict, idx: torch.Tensor) -> Dict:
    return {k: (tuple(c[idx] for c in v) if isinstance(v, tuple) else v[idx])
            for k, v in arena.items()}
