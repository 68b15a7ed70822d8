"""Turn the JAX package's state, given as numpy arrays, into the port's.

The port never imports JAX: callers fetch the JAX pytrees to the host first
(``jax.device_get``); every leaf here only has to support ``np.asarray``.
Covered:

- flax actor/critic params (``{"params": {...}}``): a Dense ``kernel
  [in, out]`` becomes ``weight [out, in]`` (the last two axes swapped);
  a ``Conv`` kernel ``[kH, kW, in, out]`` (HWIO) becomes ``[out, in, kH, kW]``
  (OIHW); ``OptimizedLSTMCell_0``'s per-gate leaves ``ii/if/ig/io``
  (kernels) and ``hi/hf/hg/ho`` (kernels and biases) are concatenated in
  gate order i, f, g, o into ``wi``, ``wh``, ``bh``.  Every rule acts on the
  trailing axes only, so twin-critic params stacked on a leading ``[2]``
  convert member by member, and a bf16-trained tree (float32 leaves, the
  same tree as float32's) converts as it is;
- the optax ``chain(clip_by_global_norm, adam)`` state (``count, mu, nu``);
- ``TrainState``, ``ArenaState``, the Pendulum env state and the whole
  phase-locked ``TrainerState``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from r2d2dpg_torch.agents.ddpg import AdamState, TrainState
from r2d2dpg_torch.envs.pendulum import PendulumState
from r2d2dpg_torch.replay.arena import ArenaState, SequenceBatch
from r2d2dpg_torch.training.assembler import StepRecord
from r2d2dpg_torch.training.trainer import TrainerState

_GATES = "ifgo"


def tensor(x: Any, device=None) -> torch.Tensor:
    """A host array as a tensor of its own (no memory shared with numpy)."""
    return torch.from_numpy(np.array(x, copy=True, order="C")).to(device)


def _dense(p: Mapping, prefix: str, out: Dict[str, np.ndarray]) -> None:
    out[f"{prefix}.weight"] = np.asarray(p["kernel"]).swapaxes(-1, -2)
    out[f"{prefix}.bias"] = np.asarray(p["bias"])


def _conv(p: Mapping, prefix: str, out: Dict[str, np.ndarray]) -> None:
    # [..., kH, kW, in, out] -> [..., out, in, kH, kW]
    out[f"{prefix}.weight"] = np.moveaxis(
        np.asarray(p["kernel"]), (-1, -2, -4, -3), (-4, -3, -2, -1)
    )
    out[f"{prefix}.bias"] = np.asarray(p["bias"])


def _lstm_cell(cell: Mapping) -> Dict[str, np.ndarray]:
    """Per-gate flax cell leaves -> fused ``wi [4H, in]``, ``wh [4H, H]``, ``bh``."""

    def fused(name):
        return np.concatenate(
            [np.asarray(cell[f"{name}{g}"]["kernel"]) for g in _GATES], axis=-1
        ).swapaxes(-1, -2)

    return {
        "wi": fused("i"),
        "wh": fused("h"),
        "bh": np.concatenate([np.asarray(cell[f"h{g}"]["bias"]) for g in _GATES], axis=-1),
    }


def lstm_cell_params_from_flax(params: Mapping, device=None) -> Dict[str, torch.Tensor]:
    """A flax ``OptimizedLSTMCell`` / ``MixedPrecisionLSTMCell``'s params
    (``{"params": {...}}``) -> the port cell's ``wi``, ``wh``, ``bh``."""
    return {k: tensor(v, device) for k, v in _lstm_cell(params["params"]).items()}


def net_params_from_flax(params: Mapping, device=None) -> Dict[str, torch.Tensor]:
    """flax ``ActorNet``/``CriticNet`` params -> the port's params dict."""
    p = params["params"]
    out: Dict[str, np.ndarray] = {}
    torso = p["torso"]
    if "Conv_0" in torso:  # ConvTorso: Conv_0..2, then Dense_0
        for i in range(len(torso) - 1):
            _conv(torso[f"Conv_{i}"], f"torso.convs.{i}", out)
        _dense(torso["Dense_0"], "torso.dense", out)
    else:
        for i in range(len(torso)):
            _dense(torso[f"Dense_{i}"], f"torso.layers.{i}", out)
    if "mix" in p:
        _dense(p["mix"], "mix", out)
    core = p["core"]
    if "OptimizedLSTMCell_0" in core:
        for k, v in _lstm_cell(core["OptimizedLSTMCell_0"]).items():
            out[f"core.cell.{k}"] = v
    else:
        _dense(core["Dense_0"], "core.dense", out)
    _dense(p["head"], "head", out)
    return {k: tensor(v, device) for k, v in out.items()}


def _find_adam(opt_state: Any) -> Any:
    """The ``ScaleByAdamState`` inside an optax (chained) state tuple."""
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _find_adam(sub)
            if found is not None:
                return found
    return None


def adam_state_from_optax(opt_state: Any, device=None) -> AdamState:
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("no optax ScaleByAdamState in the given optimizer state")
    return AdamState(
        count=int(np.asarray(adam.count)),
        mu=net_params_from_flax(adam.mu, device),
        nu=net_params_from_flax(adam.nu, device),
    )


def train_state_from_jax(ts: Any, device=None) -> TrainState:
    return TrainState(
        actor_params=net_params_from_flax(ts.actor_params, device),
        critic_params=net_params_from_flax(ts.critic_params, device),
        target_actor_params=net_params_from_flax(ts.target_actor_params, device),
        target_critic_params=net_params_from_flax(ts.target_critic_params, device),
        actor_opt_state=adam_state_from_optax(ts.actor_opt_state, device),
        critic_opt_state=adam_state_from_optax(ts.critic_opt_state, device),
        step=int(np.asarray(ts.step)),
    )


def carry_from_jax(carry: Any, device=None):
    """flax ``(c, h)`` (or the feedforward ``()``) -> a tuple of tensors."""
    return tuple(tensor(x, device) for x in carry)


def _carries(carries: Mapping, device) -> Dict[str, Any]:
    return {k: carry_from_jax(v, device) for k, v in carries.items()}


def sequence_batch_from_jax(b: Any, device=None) -> SequenceBatch:
    return SequenceBatch(
        obs=tensor(b.obs, device),
        action=tensor(b.action, device),
        reward=tensor(b.reward, device),
        discount=tensor(b.discount, device),
        reset=tensor(b.reset, device),
        carries=_carries(b.carries, device),
    )


def arena_state_from_jax(a: Any, device=None) -> ArenaState:
    return ArenaState(
        data=sequence_batch_from_jax(a.data, device),
        priority=tensor(a.priority, device),
        cursor=int(np.asarray(a.cursor)),
        total_added=int(np.asarray(a.total_added)),
        meta=tensor(a.meta, device),
    )


def pendulum_state_from_jax(s: Any, device=None) -> PendulumState:
    return PendulumState(
        theta=tensor(s.theta, device),
        thdot=tensor(s.thdot, device),
        t=tensor(s.t, device),
    )


def trainer_state_from_jax(s: Any, draws: Any, device=None) -> TrainerState:
    """A phase-locked JAX ``TrainerState`` on Pendulum -> the port's.

    ``draws`` stands in for ``s.rng``: JAX keys do not carry over, so the
    caller supplies the draws the port should consume from here on.
    """
    w = s.window
    return TrainerState(
        env_state=pendulum_state_from_jax(s.env_state, device),
        obs=tensor(s.obs, device),
        reset=tensor(s.reset, device),
        actor_carry=carry_from_jax(s.actor_carry, device),
        critic_carry=carry_from_jax(s.critic_carry, device),
        noise_state=tensor(s.noise_state, device),
        window=StepRecord(
            obs=tensor(w.obs, device),
            action=tensor(w.action, device),
            reward=tensor(w.reward, device),
            discount=tensor(w.discount, device),
            reset=tensor(w.reset, device),
            carries=_carries(w.carries, device),
        ),
        arena=arena_state_from_jax(s.arena, device),
        train=train_state_from_jax(s.train, device),
        behavior_params=net_params_from_flax(s.behavior_params, device),
        draws=draws,
        phase_idx=int(np.asarray(s.phase_idx)),
        env_steps=int(np.asarray(s.env_steps)),
        episode_return=tensor(s.episode_return, device),
        completed_return_sum=tensor(s.completed_return_sum, device),
        completed_count=tensor(s.completed_count, device),
    )
