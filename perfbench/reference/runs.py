"""The reference's side of each training cell: the same inputs, made again
from the seed, carried through the same steps by the plain code.

``learn`` follows the learn cell's first learner updates over its full
arena; ``train`` replays the train cell's set-up and first train phases:
the collectors on the stand-in with the exploration noise, the sliding
window and its emitted sequences, their entry priorities, and the learner
steps.  Each draws its uniforms and normals itself from the seed, in the
order and at the sizes the recipe asks for them (``learn_draws``,
``train_draws``), and takes from the program only the indices it sampled,
to judge them.  Each returns the outputs ``compare.training_checks``
reads, among them ``exact_priority``: the priority vector after the first
step or phase with every value written recomputed in float64, the
yardstick that any sound float32 order lies within its own rounding of.
``precision`` ``"tf32"`` is the control; ``rows`` plants the fault of a
batch half left out.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import inputs, models
from perfbench.compare import change_norms, norms
from perfbench.reference import learner as L
from perfbench.reference.nets import Precision, actor_step, critic_step, full_precision
from perfbench.traffic.standin import StandIn


SEED_HIGH = 2**31 - 1  # the env's reset seeds are integers below this


def hyper(conf: Dict) -> L.HP:
    a = conf["agent"]
    if a["target_policy_sigma"] > 0 or a["twin_critic"]:
        raise NotImplementedError("the reference has no target smoothing or twin critic")
    return L.HP(a["burnin"], a["unroll"], a["n_step"], a["gamma"], a["tau"], a["eta"],
                a["actor_lr"], a["critic_lr"], a["grad_clip"])


def schedule(conf: Dict):
    """``(window-fill, replay-fill)`` phases of the recipe: enough strides to
    fill one sequence, then enough emitted rows to reach ``min_replay``."""
    t, a = conf["trainer"], conf["agent"]
    seq = a["burnin"] + a["unroll"] + a["n_step"]
    return -(-seq // t["stride"]), -(-t["min_replay"] // t["num_envs"])


def learn_draws(conf: Dict, seed: int, device, steps: int) -> List[torch.Tensor]:
    """One uniform per batch row for each learner step, as the learn loop asks."""
    d = inputs.Draws(seed, "learner", device)
    return [d.uniform((conf["trainer"]["batch_size"],)) for _ in range(steps)]


def train_draws(conf: Dict, seed: int, device, warm: int, fill: int, phases: int
                ) -> List[torch.Tensor]:
    """The draws the train loop asks for, in its order: the envs' reset seeds,
    one normal per env and collect step, one uniform per batch row and
    learner step."""
    t, a = conf["trainer"], conf["env"]["action_dim"]
    d = inputs.Draws(seed, "trainer", device)
    out = [d.randint((t["num_envs"],), 0, SEED_HIGH)]
    for p in range(warm + fill + phases):
        out += [d.normal((t["num_envs"], a)) for _ in range(t["stride"])]
        if p >= warm + fill:
            out += [d.uniform((t["batch_size"],)) for _ in range(t["learner_steps"])]
    return out


def _outputs(st: L.LearnerState, w0, moment, losses, priority, exact, misses) -> Dict:
    """``priority`` is the vector after the first step or phase, ``exact`` its
    float64 recomputation."""
    params = {"actor": st.actor, "critic": st.critic, "target_actor": st.target_actor,
              "target_critic": st.target_critic}
    return {"losses": losses, "moment": moment, "change": change_norms(params, w0),
            "priority": priority, "exact_priority": exact, "misses": misses}


def _moment(st: L.LearnerState) -> Dict:
    return {"actor": norms(st.adam_actor.mu), "critic": norms(st.adam_critic.mu)}


def learn(conf: Dict, traffic: Dict, seed: int, device,
          program_idx: Optional[List[torch.Tensor]], precision: str = "float32",
          rows: Optional[int] = None) -> Dict:
    """The learn cell's first ``check_units`` updates, on the nets, weights
    and arena layout of the configuration's model entry."""
    full_precision()
    pr, hp, t, env = Precision(precision), hyper(conf), conf["trainer"], conf["env"]
    model = models.entry(conf)
    w0 = inputs.make_weights(model.shapes(conf), seed, device)
    cap, carries = t["capacity"], model.carries(conf)
    arena = inputs.alloc_arena(cap, model.seq_len(conf), env["obs_shape"], env["obs_dtype"],
                               env["action_dim"], carries, device)
    priority = torch.zeros(cap, device=device)
    inputs.fill_arena(arena, priority, seed, env["episode_length"], traffic["priority_range"],
                      carries)
    exact = priority.double()
    st = L.fresh_state(w0["actor"], w0["critic"], model.NETS)
    losses, moment, misses, used = [], None, 0, []
    for k, u in enumerate(learn_draws(conf, seed, device, traffic["check_units"])):
        idx = None if program_idx is None else [program_idx[k]]
        st, loss, got, bad = L.follow(st, hp, arena, priority, [u], idx, cap,
                                      t["priority_alpha"], t["beta0"], t["beta_steps"], pr,
                                      rows=rows, exact=exact if k == 0 else None)
        losses += loss
        used += got
        misses += bad
        if moment is None:
            moment, first = _moment(st), priority.clone()
    return dict(_outputs(st, w0, moment, losses, first, exact, misses), indices=used)


def train(conf: Dict, seed: int, env_seed: int, device,
          program_idx: Optional[List[torch.Tensor]], phases: int,
          precision: str = "float32", rows: Optional[int] = None) -> Dict:
    """The recipe's window-fill and replay-fill phases (``schedule``), then
    ``phases`` train phases: the LSTM entry's nets and ``(c, h)`` carries."""
    full_precision()
    pr, hp, t, env = Precision(precision), hyper(conf), conf["trainer"], conf["env"]
    e, a_dim, hid = t["num_envs"], env["action_dim"], conf["nets"]["hidden"]
    seq_len = hp.burnin + hp.unroll + hp.n_step
    warm, fill = schedule(conf)
    draws = train_draws(conf, seed, device, warm, fill, phases)
    w0 = inputs.make_weights(models.entry(conf).shapes(conf), seed, device)
    st = L.fresh_state(w0["actor"], w0["critic"])
    dyn = StandIn(env_seed, env["obs_shape"][0], a_dim, env["episode_length"])
    obs = torch.as_tensor(dyn.reset(inputs.pop(draws, (e,)).cpu().numpy()), device=device)
    reset = torch.ones(e, device=device)
    zeros = lambda *s: torch.zeros(*s, device=device)  # noqa: E731
    ca, cc = (zeros(e, hid), zeros(e, hid)), (zeros(e, hid), zeros(e, hid))
    win = {"obs": zeros(e, seq_len, env["obs_shape"][0]), "action": zeros(e, seq_len, a_dim),
           "reward": zeros(e, seq_len), "discount": zeros(e, seq_len), "reset": zeros(e, seq_len),
           "carry": zeros(e, seq_len, 4, hid)}
    i = torch.arange(e, device=device, dtype=torch.float32)
    sigma = torch.pow(torch.tensor(t["sigma_max"], device=device),
                      1.0 + t["ladder_alpha"] * i / max(e - 1, 1))
    n_rows = (fill + phases) * e
    cap = t["capacity"]
    data = {"obs": zeros(n_rows, seq_len, env["obs_shape"][0]),
            "action": zeros(n_rows, seq_len, a_dim), "reward": zeros(n_rows, seq_len),
            "discount": zeros(n_rows, seq_len), "reset": zeros(n_rows, seq_len),
            "carry_actor": (zeros(n_rows, hid), zeros(n_rows, hid)),
            "carry_critic": (zeros(n_rows, hid), zeros(n_rows, hid))}
    priority = torch.zeros(cap, device=device)
    exact = torch.zeros(cap, device=device, dtype=torch.float64)
    added = 0
    losses, moment, misses, used = [], None, 0, []

    def collect():
        nonlocal obs, reset, ca, cc
        steps = []
        for _ in range(t["stride"]):
            pre = torch.stack([ca[0], ca[1], cc[0], cc[1]], 1)
            with torch.no_grad():
                act, ca = actor_step(st.actor, obs, ca, reset, pr)
                act = (act + sigma[:, None] * inputs.pop(draws, (e, a_dim))).clamp(-1.0, 1.0)
                _, cc = critic_step(st.critic, obs, act, cc, reset, pr)
            nxt, rew, disc, done = dyn.step(act.cpu().numpy())
            steps.append((obs, act, torch.as_tensor(rew, device=device),
                          torch.as_tensor(disc, device=device), reset, pre))
            obs = torch.as_tensor(nxt, device=device)
            reset = torch.as_tensor(done, device=device)
        for key, j in (("obs", 0), ("action", 1), ("reward", 2), ("discount", 3),
                       ("reset", 4), ("carry", 5)):
            fresh = torch.stack([s[j] for s in steps], 1)
            win[key] = torch.cat([win[key][:, fresh.shape[1]:], fresh], 1)

    def emit_add():
        nonlocal added
        seq = {"obs": win["obs"], "action": win["action"], "reward": win["reward"],
               "discount": win["discount"], "reset": win["reset"],
               "carry_actor": (win["carry"][:, 0, 0], win["carry"][:, 0, 1]),
               "carry_critic": (win["carry"][:, 0, 2], win["carry"][:, 0, 3])}
        prio = L.initial_priority(st, hp, seq, pr)
        if moment is None:  # up to the first train phase's adds
            exact[added:added + e] = L.exact_priority(st, hp, seq).clamp_min(L.PRIORITY_EPS)
        rows_ = slice(added, added + e)
        for k, v in seq.items():
            if isinstance(v, tuple):
                for dst, src in zip(data[k], v):
                    dst[rows_] = src
            else:
                data[k][rows_] = v
        priority[added:added + e] = prio.clamp_min(L.PRIORITY_EPS)
        added += e

    for _ in range(warm):
        collect()
    for _ in range(fill):
        collect()
        emit_add()
    for p in range(phases):
        collect()
        emit_add()
        us = [inputs.pop(draws, (t["batch_size"],)) for _ in range(t["learner_steps"])]
        idx = None
        if program_idx is not None:
            idx = program_idx[p * t["learner_steps"]:(p + 1) * t["learner_steps"]]
        st, step_losses, got, bad = L.follow(st, hp, data, priority, us, idx, added,
                                           t["priority_alpha"], t["beta0"], t["beta_steps"],
                                           pr, rows=rows, exact=exact if p == 0 else None)
        misses += bad
        used += got
        losses.append(tuple(float(np.mean([x[j] for x in step_losses])) for j in range(2)))
        if moment is None:
            moment, first = _moment(st), priority.clone()
    return dict(_outputs(st, w0, moment, losses, first, exact, misses), indices=used,
                seqs=sequence_leaves(data))


def sequence_leaves(data: Dict) -> List[torch.Tensor]:
    return [data["obs"], data["action"], data["reward"], data["discount"], data["reset"],
            *data["carry_actor"], *data["carry_critic"]]
