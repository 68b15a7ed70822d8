"""Actor/critic nets: MLP or pixel CNN torso, LSTM core with caller-carried state."""

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
from r2d2dpg_torch.models.torsos import ConvTorso, Dense, MLPTorso

__all__ = [
    "ActorNet",
    "ConvTorso",
    "CriticNet",
    "Dense",
    "LSTMCell",
    "MLPTorso",
    "MixedPrecisionLSTMCell",
    "lstm_initial_carry",
    "policy_step_fn",
    "time_major",
    "unroll",
    "zeros_where_reset",
]
