"""Actor/critic nets: MLP torso, LSTM core with caller-carried state."""

from r2d2dpg_torch.models.actor_critic import (
    ActorNet,
    CriticNet,
    LSTMCell,
    lstm_initial_carry,
    time_major,
    unroll,
    zeros_where_reset,
)
from r2d2dpg_torch.models.torsos import Dense, MLPTorso

__all__ = [
    "ActorNet",
    "CriticNet",
    "Dense",
    "LSTMCell",
    "MLPTorso",
    "lstm_initial_carry",
    "time_major",
    "unroll",
    "zeros_where_reset",
]
