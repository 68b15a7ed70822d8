"""Port parity: the named configs and the training CLI's overrides against JAX.

Every config of the JAX package has a port config of the same name whose
agent, trainer and net fields equal JAX's, for every field the port has
(the port's ``TrainerConfig`` lacks ``overlap_learner`` and its
``AgentConfig`` lacks ``axis_name``).  The port's CLI flags give the same
config as the JAX CLI's ``_apply_overrides`` for each flag the port has.
Exact equality: these are constants.
"""

import dataclasses
import types

import pytest
import torch

from r2d2dpg_tpu.configs import CONFIGS as J_CONFIGS
from r2d2dpg_tpu.train import _apply_overrides as j_apply_overrides
from r2d2dpg_tpu.train import parse_args as j_parse_args
from r2d2dpg_torch.configs import CONFIGS, get_config
from r2d2dpg_torch.envs.core import EnvSpec
from r2d2dpg_torch.models import ConvTorso, MLPTorso, MixedPrecisionLSTMCell
from r2d2dpg_torch.train import _apply_overrides, parse_args

DMC = ("walker_r2d2", "walker_r2d2_ns5", "humanoid_r2d2", "cheetah_pixels")
NET_FIELDS = ("use_lstm", "pixels", "hidden", "compute_dtype")


def _fields_equal(port, ref):
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name


@pytest.mark.parametrize("name", sorted(J_CONFIGS))
def test_config_constants_equal_jax(name):
    port, ref = get_config(name), J_CONFIGS[name]
    assert port.name == ref.name
    _fields_equal(port.agent, ref.agent)
    _fields_equal(port.trainer, ref.trainer)
    for f in NET_FIELDS:
        assert getattr(port, f) == getattr(ref, f), f
    assert set(CONFIGS) == set(J_CONFIGS)


@pytest.mark.parametrize("name", DMC)
def test_dmc_env_factories_name_roadmap_item_7(name):
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        get_config(name).build("cpu")


@pytest.mark.parametrize("name,obs_shape,act,seq_len", [
    ("humanoid_r2d2", (67,), 21, 85),
    ("cheetah_pixels", (64, 64, 3), 6, 45),
    ("walker_r2d2_ns5", (24,), 6, 45),
])
def test_build_agent_at_published_shapes(name, obs_shape, act, seq_len):
    cfg = get_config(name)
    env = types.SimpleNamespace(spec=EnvSpec(name, obs_shape, act, pixels=cfg.pixels))
    agent = cfg.build_agent(env)
    assert agent.config.seq_len == seq_len
    torso = ConvTorso if cfg.pixels else MLPTorso
    assert isinstance(agent.actor.torso, torso) and isinstance(agent.critic.torso, torso)
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16").build_agent(env)
    assert isinstance(bf16.critic.core.cell, MixedPrecisionLSTMCell)
    p = bf16.actor.init_params(torch.Generator().manual_seed(0), "cpu")
    obs = torch.zeros((2,) + obs_shape, dtype=torch.uint8 if cfg.pixels else torch.float32)
    a, _ = bf16.actor.apply_params(p, obs, bf16.actor.initial_carry(2, "cpu"), torch.zeros(2))
    assert a.shape == (2, act) and a.dtype == torch.float32


FLAG_SETS = [
    ("--twin-critic", "1"),
    ("--twin-critic", "0"),
    ("--target-policy-sigma", "0.2"),
    ("--compute-dtype", "bfloat16"),
    ("--compute-dtype", "float32"),
    ("--n-step", "3"),
    ("--actor-lr", "3e-4"),
    ("--critic-lr", "2e-3"),
    ("--sigma-max", "0.8"),
    ("--ladder-alpha", "4.5"),
    ("--seed", "9"),
    ("--twin-critic", "1", "--target-policy-sigma", "0.2", "--compute-dtype",
     "bfloat16", "--n-step", "4", "--actor-lr", "1e-3", "--critic-lr", "5e-4",
     "--sigma-max", "0.5", "--ladder-alpha", "3"),
]


@pytest.mark.parametrize("name", ["pendulum_r2d2", "cheetah_pixels"])
@pytest.mark.parametrize("flags", FLAG_SETS, ids=lambda f: "_".join(f))
def test_cli_overrides_equal_jax(name, flags):
    argv = ["--config", name, *flags]
    port = _apply_overrides(get_config(name), parse_args(argv))
    ref = j_apply_overrides(J_CONFIGS[name], j_parse_args(argv))
    _fields_equal(port.agent, ref.agent)
    _fields_equal(port.trainer, ref.trainer)
    for f in NET_FIELDS:
        assert getattr(port, f) == getattr(ref, f), f
