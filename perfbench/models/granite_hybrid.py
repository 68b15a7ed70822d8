"""The R2D2-DPG recipe's nets with granite-4.0-h-micro's hybrid core: a model
entry (``models/__init__.py`` lists what an entry gives), and the only plain
reference of that core.

Written from the published config (``ibm-granite/granite-4.0-h-micro``,
``granitemoehybrid``) and the layer equations, not from the measured
program, one time step at a time, in float32 (TF32 off).  Per decoder
layer, ``r`` the residual multiplier:

- ``h = x + r * mixer(RMSNorm(x))``, then ``h + r * MLP(RMSNorm(h))``;
  ``RMSNorm(v) = w * v / sqrt(mean(v^2) + eps)``; ``MLP(u) = W_out (silu(a)
  * b)`` with ``[a, b] = W_in u``;
- Mamba-2 (one group): ``in_proj`` gives the gate ``z``, ``xBC`` and ``dt``;
  ``xBC`` runs through a causal depthwise convolution over the layer's last
  ``d_conv`` inputs (with bias) and ``silu``, and splits into ``x`` (heads
  of ``d_head``), ``B`` and ``C``; ``dt = softplus(dt + dt_bias)``, ``A =
  -exp(A_log)``; per head ``S <- exp(dt A) S + dt x B^T``, ``y = S C + D x``;
  ``out_proj(RMSNorm(y * silu(z)))``;
- attention: grouped queries (query head ``i`` reads key head ``i // g``),
  no positional encoding, scores ``q . k * attention_multiplier``, causal
  softmax over every position of the sequence so far that no reset has
  cut;
- the core's input is ``embedding_multiplier`` times the torso's output
  (the critic's ``mix`` output) and a final RMSNorm follows the stack; the
  recipe's heads take its output (no language-model head, so no logits
  scaling).

A net's state is, per layer, the convolution's last ``d_conv - 1`` inputs
and ``S`` (Mamba-2), or the keys and values of the sequence so far with a
mask of those a reset has not cut (attention).  A reset zeroes a row's
state before its step.  Replay is R2D2's zero start: the arena stores no
carry (``carries``), and a carry of ``()`` is the empty state.

The reference learner update (``update``) is ``reference/learner.py``'s,
with the nets above, the burn-in and targets over the whole batch (no
gradient), and the two losses and their gradients over blocks of
``BLOCK_ROWS`` rows: autograd through the step form keeps every step's
``S`` (2 MiB a row and layer), which for the whole batch would not fit
beside the state on one card.  Each loss is a mean over rows and steps,
so its gradient is the sum of the blocks' gradients of their share.
Adam and Polyak run in place on the reference's own state, and the
float64 priorities convert each weight as it is used, for the same
reason.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench import inputs
from perfbench.compare import change_norms, norms
from perfbench.reference import learner as L
from perfbench.reference import runs
from perfbench.reference.nets import Precision, full_precision, to_tf32, torso

BLOCK_ROWS = 16


@dataclasses.dataclass(frozen=True)
class Widths:
    """The core's numbers, read from a configuration's top-level keys (the
    published config's names; ``layer_types`` cut to ``num_hidden_layers``)."""

    hidden_size: int
    shared_intermediate_size: int
    layer_types: Tuple[str, ...]
    mamba_n_heads: int
    mamba_d_head: int
    mamba_d_state: int
    mamba_d_conv: int
    num_attention_heads: int
    num_key_value_heads: int
    residual_multiplier: float
    attention_multiplier: float
    embedding_multiplier: float
    rms_norm_eps: float

    @property
    def inner(self) -> int:
        return self.mamba_n_heads * self.mamba_d_head

    @property
    def conv_dim(self) -> int:
        return self.inner + 2 * self.mamba_d_state

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_dim(self) -> int:
        return self.num_key_value_heads * self.head_dim


def widths(conf: Dict) -> Widths:
    names = [f.name for f in dataclasses.fields(Widths) if f.name != "layer_types"]
    return Widths(layer_types=tuple(conf["layer_types"][:conf["num_hidden_layers"]]),
                  **{k: conf[k] for k in names})


# ---------------------------------------------------------------- the nets
def _rms(v, w, eps):
    return w * v / torch.sqrt(v.pow(2).mean(-1, keepdim=True) + eps)


def _matmul(pr: Precision, a, b):
    return torch.matmul(pr.round(a), pr.round(b))


def _mm(pr: Precision, x, w):
    """``x @ w^T`` with ``w`` rounded already (``rounded``)."""
    return torch.matmul(pr.round(x), w.t())


def rounded(p, pr: Precision):
    """``p`` with the weight of every matrix product (each 2-D leaf) rounded to
    ``pr`` once, as the nets take them: a weight rounded at each use would
    be kept by autograd at every step (the TF32 control would not fit)."""
    if pr.round is not to_tf32:
        return p
    return {k: pr.round(v) if v.dim() == 2 else v for k, v in p.items()}


class Nets:
    """One step of the actor and of the critic (``reference/learner.py``'s
    ``actor_step`` / ``critic_step``) at widths ``w``, on params that came
    through ``rounded`` (the identity in float32)."""

    def __init__(self, w: Widths):
        self.w = w

    def empty(self, x: torch.Tensor):
        """The zero-start state of ``x.shape[0]`` rows."""
        w, n = self.w, x.shape[0]
        z = lambda *s: torch.zeros(s, dtype=x.dtype, device=x.device)  # noqa: E731
        return tuple(
            (z(n, w.mamba_d_conv - 1, w.conv_dim),
             z(n, w.mamba_n_heads, w.mamba_d_head, w.mamba_d_state)) if kind == "mamba"
            else (z(n, 0, w.num_key_value_heads, w.head_dim),
                  z(n, 0, w.num_key_value_heads, w.head_dim),
                  torch.zeros(n, 0, dtype=torch.bool, device=x.device))
            for kind in w.layer_types)

    def _mamba(self, p, pre, u, carry, keep, pr):
        w = self.w
        n = u.shape[0]
        window, s = carry
        window = window * keep[:, None, None]
        z, xbc, dt = _mm(pr, u, p[pre + "in_proj.weight"]).split(
            [w.inner, w.conv_dim, w.mamba_n_heads], -1)
        taps = torch.cat([window, xbc[:, None]], 1)  # [N, d_conv, C], oldest first
        conv = (taps * p[pre + "conv1d.weight"][:, 0].t()).sum(1)
        xbc = F.silu(conv + p[pre + "conv1d.bias"])
        x, b, c = xbc.split([w.inner, w.mamba_d_state, w.mamba_d_state], -1)
        x = x.reshape(n, w.mamba_n_heads, w.mamba_d_head)
        dt = F.softplus(dt + p[pre + "dt_bias"])  # [N, H]
        a = -torch.exp(p[pre + "A_log"])
        # The reset zeroes S with the decay: one product of S a step.
        s = ((keep[:, None] * torch.exp(dt * a))[:, :, None, None] * s
             + (dt[:, :, None] * x)[:, :, :, None] * b[:, None, None, :])
        y = _matmul(pr, s, c[:, None, :, None])[..., 0] + p[pre + "D"][:, None] * x
        g = y.reshape(n, w.inner) * F.silu(z)
        y = _rms(g, p[pre + "norm.weight"], w.rms_norm_eps)
        return _mm(pr, y, p[pre + "out_proj.weight"]), (taps[:, 1:], s)

    def _attention(self, p, pre, u, carry, keep, pr):
        w = self.w
        n, hd, g = u.shape[0], w.head_dim, w.num_attention_heads // w.num_key_value_heads
        keys, values, live = carry
        q = _mm(pr, u, p[pre + "q_proj.weight"]).reshape(n, w.num_attention_heads, 1, hd)
        k = _mm(pr, u, p[pre + "k_proj.weight"]).reshape(n, 1, w.num_key_value_heads, hd)
        v = _mm(pr, u, p[pre + "v_proj.weight"]).reshape(n, 1, w.num_key_value_heads, hd)
        keys, values = torch.cat([keys, k], 1), torch.cat([values, v], 1)
        live = torch.cat([live & keep[:, None].bool(),
                          torch.ones(n, 1, dtype=torch.bool, device=u.device)], 1)
        kh = keys.repeat_interleave(g, 2).permute(0, 2, 3, 1)  # [N, heads, hd, len]
        vh = values.repeat_interleave(g, 2).permute(0, 2, 1, 3)  # [N, heads, len, hd]
        scores = _matmul(pr, q, kh) * w.attention_multiplier
        scores = scores.masked_fill(~live[:, None, None, :], -math.inf)
        o = _matmul(pr, torch.softmax(scores, -1), vh).reshape(n, w.hidden_size)
        return _mm(pr, o, p[pre + "o_proj.weight"]), (keys, values, live)

    def core(self, p, x, carry, reset, pr):
        w = self.w
        if carry == ():
            carry = self.empty(x)
        keep = (reset <= 0).to(x.dtype)
        h = w.embedding_multiplier * x
        out = []
        for i, kind in enumerate(w.layer_types):
            pre = f"core.layers.{i}."
            u = _rms(h, p[pre + "input_layernorm.weight"], w.rms_norm_eps)
            mixer = self._mamba if kind == "mamba" else self._attention
            m, c = mixer(p, pre + ("mamba." if kind == "mamba" else "self_attn."), u,
                         carry[i], keep, pr)
            h = h + w.residual_multiplier * m
            u = _rms(h, p[pre + "post_attention_layernorm.weight"], w.rms_norm_eps)
            a, b = _mm(pr, u, p[pre + "shared_mlp.input_linear.weight"]).chunk(2, -1)
            h = h + w.residual_multiplier * _mm(pr, F.silu(a) * b,
                                                  p[pre + "shared_mlp.output_linear.weight"])
            out.append(c)
        return _rms(h, p["core.norm.weight"], w.rms_norm_eps), tuple(out)

    def actor_step(self, p, obs, carry, reset, pr):
        """``(action [N, A], carry)``."""
        y, carry = self.core(p, torso(p, obs, pr), carry, reset, pr)
        return torch.tanh(_mm(pr, y, p["head.weight"]) + p["head.bias"]), carry

    def critic_step(self, p, obs, action, carry, reset, pr):
        """``(q [N], carry)``."""
        x = torch.cat([torso(p, obs, pr), action], dim=-1)
        m = torch.relu(_mm(pr, x, p["mix.weight"]) + p["mix.bias"])
        y, carry = self.core(p, m, carry, reset, pr)
        return (_mm(pr, y, p["head.weight"]) + p["head.bias"])[:, 0], carry


def nets(conf: Dict) -> Nets:
    return Nets(widths(conf))


# ------------------------------------------------------------- the entry
def shapes(conf: Dict):
    w, env = widths(conf), conf["env"]
    (obs,), act, d = env["obs_shape"], env["action_dim"], w.hidden_size
    core = {}
    for i, kind in enumerate(w.layer_types):
        pre = f"core.layers.{i}."
        core[pre + "input_layernorm.weight"] = (d,)
        if kind == "mamba":
            m = pre + "mamba."
            core.update({m + "in_proj.weight": (w.inner + w.conv_dim + w.mamba_n_heads, d),
                         m + "conv1d.weight": (w.conv_dim, 1, w.mamba_d_conv),
                         m + "conv1d.bias": (w.conv_dim,), m + "dt_bias": (w.mamba_n_heads,),
                         m + "A_log": (w.mamba_n_heads,), m + "D": (w.mamba_n_heads,),
                         m + "norm.weight": (w.inner,), m + "out_proj.weight": (d, w.inner)})
        else:
            a = pre + "self_attn."
            core.update({a + "q_proj.weight": (d, d), a + "k_proj.weight": (w.kv_dim, d),
                         a + "v_proj.weight": (w.kv_dim, d), a + "o_proj.weight": (d, d)})
        core[pre + "post_attention_layernorm.weight"] = (d,)
        core[pre + "shared_mlp.input_linear.weight"] = (2 * w.shared_intermediate_size, d)
        core[pre + "shared_mlp.output_linear.weight"] = (d, w.shared_intermediate_size)
    core["core.norm.weight"] = (d,)
    torso_ = {"torso.layers.0.weight": (d, obs), "torso.layers.0.bias": (d,)}
    return {"actor": {**torso_, **core, "head.weight": (act, d), "head.bias": (act,)},
            "critic": {**torso_, "mix.weight": (d, d + act), "mix.bias": (d,), **core,
                       "head.weight": (1, d), "head.bias": (1,)}}


def carries(conf: Dict):
    """Zero start: the arena stores no carry."""
    return {"actor": [], "critic": []}


def seq_len(conf: Dict) -> int:
    a = conf["agent"]
    return a["burnin"] + a["unroll"] + a["n_step"]


# ------------------------------------------------------------------ FLOPs
def _forward(w: Widths, keys: int) -> Tuple[int, int]:
    """2 x the multiply-adds of one row through the core's layers at a step
    with ``keys`` positions to attend: ``(weights' products, the attention's
    scores and mix over the keys)``."""
    d, m = w.hidden_size, w.shared_intermediate_size
    mamba = (2 * d * (w.inner + w.conv_dim + w.mamba_n_heads) + 2 * w.inner * d
             + 2 * w.mamba_n_heads * w.mamba_d_head * w.mamba_d_state)
    attention = 2 * d * (2 * d + 2 * w.kv_dim)
    mlp = 2 * d * 2 * m + 2 * m * d
    n_attn = sum(kind == "attention" for kind in w.layer_types)
    weights = (len(w.layer_types) - n_attn) * mamba + n_attn * attention + len(w.layer_types) * mlp
    return weights, n_attn * 4 * d * keys


def learner_step(conf: Dict) -> int:
    """2 x the multiply-adds of every matrix product one learner update
    needs at the configuration's batch: the burn-in of the four nets, the
    targets, and each update's forward and backward.  A backward product is
    counted where its result is needed: every trained weight's gradient,
    and an input's where the input depends on the trained parameters (not
    the observation, the replayed action in the critic update, the frozen
    critic's torso, or the keys and values that burn-in hands over).  The
    SSM readout ``S C`` is a product of two such inputs; the state update
    ``dt x B^T`` is an outer product, no sum."""
    w, env, a = widths(conf), conf["env"], conf["agent"]
    rows, b, u, n = conf["trainer"]["batch_size"], a["burnin"], a["unroll"], a["n_step"]
    d, act, obs = w.hidden_size, env["action_dim"], env["obs_shape"][0]
    torso_, mix = 2 * obs * d, 2 * (d + act) * d
    heads = 2 * d * act + 2 * d
    readout = 2 * w.mamba_n_heads * w.mamba_d_head * w.mamba_d_state
    n_mamba = sum(kind == "mamba" for kind in w.layer_types)
    n_attn = len(w.layer_types) - n_mamba

    def both(keys):  # actor and critic forward, one row and step
        weights, attn = _forward(w, keys)
        return 2 * (torso_ + weights + attn) + mix + heads

    total = rows * sum(2 * both(t + 1) for t in range(b))  # online and target
    total += rows * sum(both(b + t + 1) for t in range(u + n))
    for t in range(u):
        keys = b + t + 1
        weights, attn = _forward(w, keys)
        core, linear = weights + attn, weights - n_mamba * readout
        # The core's input gradients: each projection's, both factors of
        # the readout, the query's and the scores' over every key, and the
        # keys' and values' of this unroll (not burn-in's).
        core_dx = linear + n_mamba * 2 * readout + n_attn * (4 * d * keys + 4 * d * (keys - b))
        # Critic update: forward; weight gradients; input gradients.
        total += rows * (torso_ + mix + core + 2 * d)
        total += rows * (torso_ + mix + linear + 2 * d)
        total += rows * (2 * d * d + core_dx + 2 * d)
        # Actor update: both nets forward; the actor's weight and input
        # gradients; the frozen critic's input gradients along the action.
        total += rows * (2 * (torso_ + core) + mix + heads)
        total += rows * (torso_ + linear + 2 * d * act)
        total += rows * (core_dx + 2 * d * act)
        total += rows * (2 * act * d + core_dx + 2 * d)
    return total


def learn_unit(conf: Dict) -> int:
    return learner_step(conf)


# ---------------------------------------------------- the reference update
class _AsDouble(dict):
    """A params dict whose tensors are handed out in float64, one at a time."""

    def __getitem__(self, key):
        return super().__getitem__(key).double()


def _rows(tree, sl):
    if isinstance(tree, torch.Tensor):
        return tree[sl]
    return tuple(_rows(x, sl) for x in tree)


def _burn_in_and_targets(st: L.LearnerState, hp: L.HP, batch: Dict, pr: Precision):
    with torch.no_grad():
        ca_on, ca_tg, cc_on, cc_tg = L.burn_in(st, hp, batch, pr)
        return ca_on, cc_on, L.targets(st, hp, batch, ca_tg, cc_tg, pr)


def update(st: L.LearnerState, hp: L.HP, batch: Dict, weights: torch.Tensor,
           pr: Precision, rows: Optional[int] = None, block: int = BLOCK_ROWS):
    """``reference/learner.update`` over blocks of ``block`` rows, with
    Adam and Polyak in place on ``st``'s tensors: ``(st, priorities [B],
    losses, clipped gradients)``.  ``rows`` keeps the first ``rows`` of the
    batch (the planted fault of a batch half left out)."""
    if rows is not None:
        batch = {k: _rows(v, slice(0, rows)) for k, v in batch.items()}
        weights = weights[:rows]
    u, n_rows = hp.unroll, weights.shape[0]
    ca_on, cc_on, y = _burn_in_and_targets(dataclasses.replace(
        st, actor=rounded(st.actor, pr), critic=rounded(st.critic, pr),
        target_actor=rounded(st.target_actor, pr),
        target_critic=rounded(st.target_critic, pr)), hp, batch, pr)
    w = slice(hp.burnin, hp.burnin + u)
    obs, act, rst = batch["obs"][:, w], batch["action"][:, w], batch["reset"][:, w]
    cp = {k: v.detach().requires_grad_(True) for k, v in st.critic.items()}
    ap = {k: v.detach().requires_grad_(True) for k, v in st.actor.items()}
    cp_r, ap_r = rounded(cp, pr), rounded(ap, pr)
    frozen = {k: v.detach() for k, v in cp_r.items()}
    g_critic = {k: torch.zeros_like(v) for k, v in cp.items()}
    g_actor = {k: torch.zeros_like(v) for k, v in ap.items()}
    critic_loss = actor_loss = 0.0
    tds = []
    for lo in range(0, n_rows, block):
        sl = slice(lo, min(lo + block, n_rows))
        q, _ = L.unroll_critic(st.nets, cp_r, _rows(cc_on, sl), obs[sl], act[sl], rst[sl], pr)
        td = y[sl] - q
        loss = (weights[sl, None] * L.huber(td)).sum() / (n_rows * u)
        for k, g in zip(cp, torch.autograd.grad(loss, list(cp.values()))):
            g_critic[k] += g
        critic_loss += loss.item()
        tds.append(td.detach())
        q_pi, _ = L.unroll_pi_q(st.nets, ap_r, frozen, _rows(ca_on, sl), _rows(cc_on, sl),
                                obs[sl], rst[sl], pr)
        loss = -q_pi.sum() / (n_rows * u)
        for k, g in zip(ap, torch.autograd.grad(loss, list(ap.values()))):
            g_actor[k] += g
        actor_loss += loss.item()
        del q, q_pi, loss
    del cp_r, ap_r, frozen
    with torch.no_grad():
        g_critic = L._clip(g_critic, hp.grad_clip)
        g_actor = L._clip(g_actor, hp.grad_clip)
        _adam_(st.critic, g_critic, st.adam_critic, hp.critic_lr)
        _adam_(st.actor, g_actor, st.adam_actor, hp.actor_lr)
        for new, old in ((st.actor, st.target_actor), (st.critic, st.target_critic)):
            for k in old:
                old[k].copy_(hp.tau * new[k] + (1 - hp.tau) * old[k])
        st.step += 1
        prio = L.priorities(torch.cat(tds), hp.eta)
    return st, prio, (critic_loss, actor_loss), {"actor": g_actor, "critic": g_critic}


def _adam_(p, g, st: L.Adam, lr: float, b1=0.9, b2=0.999, eps=1e-8) -> None:
    """``reference/learner._adam``'s arithmetic, leaf by leaf in place."""
    st.count += 1
    bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(st.count))
    bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(st.count))
    for k in p:
        st.mu[k].copy_((1 - b1) * g[k] + b1 * st.mu[k])
        st.nu[k].copy_((1 - b2) * (g[k] * g[k]) + b2 * st.nu[k])
        p[k].copy_(p[k] + (-lr) * ((st.mu[k] / bc1) / (torch.sqrt(st.nu[k] / bc2) + eps)))


@torch.no_grad()
def exact_priority(st: L.LearnerState, hp: L.HP, batch: Dict) -> torch.Tensor:
    """``reference/learner.exact_priority`` with each weight converted to
    float64 as it is used."""
    st64 = dataclasses.replace(st, actor=_AsDouble(st.actor), critic=_AsDouble(st.critic),
                               target_actor=_AsDouble(st.target_actor),
                               target_critic=_AsDouble(st.target_critic))
    batch64 = {k: v if v.dtype == torch.uint8 else v.double() for k, v in batch.items()
               if isinstance(v, torch.Tensor)}
    batch64.update(carry_actor=(), carry_critic=())
    return L.initial_priority(st64, hp, batch64, Precision("float32"))


def follow(st, hp, arena, priority, draws, program_idx, size, alpha, beta0, beta_steps, pr,
           rows=None, exact=None):
    """``reference/learner.follow`` with this entry's ``update``."""
    losses, used, misses = [], [], 0
    for k, u in enumerate(draws):
        idx, _, cdf, total, scaled = L.sample(priority, u, alpha)
        if program_idx is not None:
            bad = L.index_misses(program_idx[k], u, cdf, total, scaled)
            misses += bad
            if bad == 0:
                idx = program_idx[k].to(idx.device).long()
        w = L.is_weights(scaled[idx] / total, size, L.anneal_beta(st.step, beta0, beta_steps))
        batch = L.gather(arena, idx)
        if exact is not None:
            kept = batch if rows is None else L.gather(batch, slice(0, rows))
            L.write_back(exact, idx[:rows], exact_priority(st, hp, kept))
        st, prio, loss, _ = update(st, hp, batch, w, pr, rows=rows)
        idx = idx if rows is None else idx[:rows]
        L.write_back(priority, idx, prio)
        losses.append(loss)
        used.append(idx)
    return st, losses, used, misses


def learn(conf: Dict, traffic: Dict, seed: int, device,
          program_idx: Optional[List[torch.Tensor]], precision: str = "float32",
          rows: Optional[int] = None) -> Dict:
    """The learn cell's first ``check_units`` updates (``reference/runs.learn``
    with this entry's nets, ``follow`` and ``update``)."""
    full_precision()
    pr, hp, t, env = Precision(precision), runs.hyper(conf), conf["trainer"], conf["env"]
    w0 = inputs.make_weights(shapes(conf), seed, device)
    cap = t["capacity"]
    arena = inputs.alloc_arena(cap, seq_len(conf), env["obs_shape"], env["obs_dtype"],
                               env["action_dim"], carries(conf), device)
    priority = torch.zeros(cap, device=device)
    inputs.fill_arena(arena, priority, seed, env["episode_length"], traffic["priority_range"],
                      carries(conf))
    exact = priority.double()
    st = L.fresh_state(w0["actor"], w0["critic"], nets(conf))
    losses, moment, misses, used = [], None, 0, []
    for k, u in enumerate(runs.learn_draws(conf, seed, device, traffic["check_units"])):
        idx = None if program_idx is None else [program_idx[k]]
        st, loss, got, bad = follow(st, hp, arena, priority, [u], idx, cap,
                                    t["priority_alpha"], t["beta0"], t["beta_steps"], pr,
                                    rows=rows, exact=exact if k == 0 else None)
        losses += loss
        used += got
        misses += bad
        if moment is None:
            moment = {"actor": norms(st.adam_actor.mu), "critic": norms(st.adam_critic.mu)}
            first = priority.clone()
    params = {"actor": st.actor, "critic": st.critic, "target_actor": st.target_actor,
              "target_critic": st.target_critic}
    return {"losses": losses, "moment": moment, "change": change_norms(params, w0),
            "priority": first, "exact_priority": exact, "misses": misses, "indices": used}
