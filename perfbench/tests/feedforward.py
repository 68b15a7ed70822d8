"""A model entry with a feed-forward core, for the tests only: the recipe's
nets with one ReLU dense layer in place of the LSTM (the program's
``use_lstm=False``) and no stored carry.

It stands for a configuration of a new architecture: with this file, its
configuration and the program's config of the same numbers, the learn loop
runs and is judged with no edit to a file the harness has.  The tests put
it where the harness looks for entries (``perfbench/models/``).
"""

from __future__ import annotations

from typing import Dict

import torch

from perfbench.reference import runs
from perfbench.reference.nets import torso

learn = runs.learn


def _core(p, x, pr):
    return torch.relu(pr.mm(x, p["core.dense.weight"]) + p["core.dense.bias"])


class NETS:
    """One step of each net; the carry is ``()`` and passes through."""

    @staticmethod
    def actor_step(p, obs, carry, reset, pr):
        y = _core(p, torso(p, obs, pr), pr)
        return torch.tanh(pr.mm(y, p["head.weight"]) + p["head.bias"]), carry

    @staticmethod
    def critic_step(p, obs, action, carry, reset, pr):
        x = torch.cat([torso(p, obs, pr), action], dim=-1)
        m = torch.relu(pr.mm(x, p["mix.weight"]) + p["mix.bias"])
        y = _core(p, m, pr)
        return (pr.mm(y, p["head.weight"]) + p["head.bias"])[:, 0], carry


def shapes(conf: Dict):
    (obs,), a, h = conf["env"]["obs_shape"], conf["env"]["action_dim"], conf["nets"]["hidden"]
    torso_ = {"torso.layers.0.weight": (h, obs), "torso.layers.0.bias": (h,)}
    core = {"core.dense.weight": (h, h), "core.dense.bias": (h,)}
    return {"actor": {**torso_, **core, "head.weight": (a, h), "head.bias": (a,)},
            "critic": {**torso_, "mix.weight": (h, h + a), "mix.bias": (h,), **core,
                       "head.weight": (1, h), "head.bias": (1,)}}


def carries(conf: Dict):
    return {"actor": [], "critic": []}


def seq_len(conf: Dict) -> int:
    a = conf["agent"]
    return a["burnin"] + a["unroll"] + a["n_step"]


def learn_unit(conf: Dict) -> int:
    """Three times the forward products of both nets over the batch's
    sequences: a rough count, enough for the tests' readings."""
    s = {k: sum(torch.Size(v).numel() for key, v in shape.items() if key.endswith("weight"))
         for k, shape in shapes(conf).items()}
    return 3 * 2 * (s["actor"] + s["critic"]) * conf["trainer"]["batch_size"] * seq_len(conf)
