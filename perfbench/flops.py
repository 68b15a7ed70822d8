"""Analytic FLOPs of the recipe's work with the LSTM core (the ``lstm`` model
entry's count), from a configuration's shapes alone.

Counts ``2 x`` the multiply-adds of every matmul and convolution that the
algorithm needs, and nothing else: elementwise work (gates, activations,
Adam, Polyak, n-step sums) is left out, and so is any recomputation.  A
backward product is counted only where its result is needed: the weight
gradient of every trained layer, and the input gradient only where that
input depends on the trained parameters (not for the observation, the
replayed action in the critic update, a frozen net's torso, or the carry
that burn-in hands to the first unrolled step).  The count is the same
whatever kernels compute the work, so a program that fuses, graphs or
hand-writes its kernels is held to the same work.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

CONV_LAYERS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))


@dataclasses.dataclass(frozen=True)
class Shapes:
    obs_shape: Sequence[int]
    action_dim: int
    hidden: int
    pixels: bool


def shapes_of(conf: Dict) -> Shapes:
    env, nets = conf["env"], conf["nets"]
    return Shapes(tuple(env["obs_shape"]), env["action_dim"], nets["hidden"], nets["pixels"])


def torso_layers(s: Shapes):
    """Forward FLOPs per row of each torso layer, input side first."""
    h = s.hidden
    if not s.pixels:
        return [2 * s.obs_shape[0] * h]
    height, width, c = s.obs_shape
    out = []
    for f, k, st in CONV_LAYERS:
        height, width = (height - k) // st + 1, (width - k) // st + 1
        out.append(2 * height * width * f * c * k * k)
        c = f
    out.append(2 * height * width * c * h)
    return out


def per_row(s: Shapes) -> Dict[str, int]:
    """Forward FLOPs per row and step of each part of the two nets."""
    h, a = s.hidden, s.action_dim
    torso = torso_layers(s)
    return {
        "torso": sum(torso),
        "torso_dx": sum(torso[1:]),  # input gradients past the first layer
        "lstm_in": 8 * h * h,  # x Wi^T, Wi [4H, H]
        "lstm_rec": 8 * h * h,  # h Wh^T
        "actor_head": 2 * h * a,
        "mix_x": 2 * h * h,
        "mix_a": 2 * a * h,
        "critic_head": 2 * h,
    }


def forward(s: Shapes) -> Dict[str, int]:
    """Forward FLOPs of one row through one step of each net."""
    p = per_row(s)
    lstm = p["lstm_in"] + p["lstm_rec"]
    return {
        "actor": p["torso"] + lstm + p["actor_head"],
        "critic": p["torso"] + p["mix_x"] + p["mix_a"] + lstm + p["critic_head"],
    }


def learner_step(s: Shapes, batch: int, burnin: int, unroll: int, n_step: int) -> int:
    """One learner update at ``batch`` rows."""
    f, p = forward(s), per_row(s)
    both = f["actor"] + f["critic"]
    window = unroll + n_step
    rows = batch * unroll
    total = 2 * both * batch * burnin  # online and target, no gradient
    total += both * batch * window  # target pi and Q
    # Critic update: forward, then every weight gradient and the input
    # gradients back to the torso's second layer; the recurrent input
    # gradient from step 1 on.
    crit_w = p["torso"] + p["mix_x"] + p["mix_a"] + p["lstm_in"] + p["lstm_rec"] + p["critic_head"]
    crit_x = p["torso_dx"] + p["mix_x"] + p["lstm_in"] + p["critic_head"]
    total += f["critic"] * rows + (crit_w + crit_x) * rows + p["lstm_rec"] * batch * (unroll - 1)
    # Actor update: both nets forward; the actor's weight and input
    # gradients; the frozen critic's input gradients along the action.
    act_w = p["torso"] + p["lstm_in"] + p["lstm_rec"] + p["actor_head"]
    act_x = p["torso_dx"] + p["lstm_in"] + p["actor_head"]
    crit_a = p["critic_head"] + p["lstm_in"] + p["mix_a"]
    total += both * rows + (act_w + act_x + crit_a) * rows
    total += 2 * p["lstm_rec"] * batch * (unroll - 1)  # both nets' recurrence
    return total


def initial_priority(s: Shapes, rows: int, burnin: int, unroll: int, n_step: int) -> int:
    """The TD priority of ``rows`` fresh sequences (no gradient)."""
    f = forward(s)
    both = f["actor"] + f["critic"]
    return 2 * both * rows * burnin + both * rows * (unroll + n_step) + f["critic"] * rows * unroll


def collect_step(s: Shapes, rows: int) -> int:
    """One policy step of ``rows`` envs: the action and the critic's carry."""
    f = forward(s)
    return (f["actor"] + f["critic"]) * rows


def train_phase(s: Shapes, agent: Dict, trainer: Dict) -> int:
    """One train phase: ``stride`` policy steps of every env, the entry
    priority of the emitted sequences, and the phase's learner steps."""
    e = trainer["num_envs"]
    b, u, n = agent["burnin"], agent["unroll"], agent["n_step"]
    return (trainer["stride"] * collect_step(s, e)
            + initial_priority(s, e, b, u, n)
            + trainer["learner_steps"] * learner_step(s, trainer["batch_size"], b, u, n))

