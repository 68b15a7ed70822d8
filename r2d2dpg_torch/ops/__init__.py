"""Pure update math on tensors, plus the priority-scatter kernel wrapper."""

from r2d2dpg_torch.ops.noise import gaussian_noise, ou_step, sigma_ladder
from r2d2dpg_torch.ops.polyak import hard_update, polyak_update
from r2d2dpg_torch.ops.priority import (
    PRIORITY_EPS,
    anneal_beta,
    importance_weights,
    sequence_priority,
)
from r2d2dpg_torch.ops.returns import huber, n_step_targets, td_errors
from r2d2dpg_torch.ops.scatter import priority_scatter, priority_scatter_plain

__all__ = [
    "PRIORITY_EPS",
    "anneal_beta",
    "gaussian_noise",
    "hard_update",
    "huber",
    "importance_weights",
    "n_step_targets",
    "ou_step",
    "polyak_update",
    "priority_scatter",
    "priority_scatter_plain",
    "sequence_priority",
    "sigma_ladder",
    "td_errors",
]
