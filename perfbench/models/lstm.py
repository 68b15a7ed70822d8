"""The R2D2-DPG recipe's nets with an LSTM core: the default model entry
(``models/__init__.py`` lists what an entry gives).

The torso (dense, or the Nature-DQN stack over frames), an LSTM cell of
``hidden`` units and the heads (``reference/nets.py``); the arena stores
each net's ``(c, h)`` at the start of every sequence; the reference runs of
``reference/runs.py`` and ``reference/rollout.py``; the FLOP count of
``flops.py``.
"""

from __future__ import annotations

from typing import Dict

from perfbench import flops
from perfbench.reference import nets, rollout, runs
from perfbench.reference.nets import param_shapes

NETS = nets
learn = runs.learn
train = runs.train
actions = rollout.actions


def shapes(conf: Dict):
    env, n = conf["env"], conf["nets"]
    return param_shapes(env["obs_shape"], env["action_dim"], n["hidden"], n["pixels"])


def carries(conf: Dict):
    """``(c, h)`` of each net: ``c ~ N(0, 0.25)``, ``h ~ U(-0.5, 0.5)``."""
    h = conf["nets"]["hidden"]
    leaves = [("normal", (h,)), ("uniform", (h,))]
    return {"actor": leaves, "critic": leaves}


def seq_len(conf: Dict) -> int:
    a = conf["agent"]
    return a["burnin"] + a["unroll"] + a["n_step"]


def learn_unit(conf: Dict) -> int:
    a, t = conf["agent"], conf["trainer"]
    return flops.learner_step(flops.shapes_of(conf), t["batch_size"], a["burnin"], a["unroll"],
                              a["n_step"])


def train_unit(conf: Dict) -> int:
    return flops.train_phase(flops.shapes_of(conf), conf["agent"], conf["trainer"])

