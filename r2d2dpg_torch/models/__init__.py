"""Actor/critic nets: MLP or pixel CNN torso; LSTM or Granite-4.0-H hybrid core
with caller-carried state."""

from r2d2dpg_torch.models.actor_critic import (
    ActorNet,
    CriticNet,
    LSTMCell,
    MixedPrecisionLSTMCell,
    lstm_initial_carry,
    policy_step_fn,
    time_major,
    unroll,
    zeros_where_reset,
)
from r2d2dpg_torch.models.granite import GRANITE_4_0_H_MICRO, GraniteSpec
from r2d2dpg_torch.models.torsos import ConvTorso, Dense, MLPTorso

__all__ = [
    "GRANITE_4_0_H_MICRO",
    "ActorNet",
    "ConvTorso",
    "CriticNet",
    "Dense",
    "GraniteSpec",
    "LSTMCell",
    "MLPTorso",
    "MixedPrecisionLSTMCell",
    "lstm_initial_carry",
    "policy_step_fn",
    "time_major",
    "unroll",
    "zeros_where_reset",
]
