"""Prioritized-replay math: eta-mix sequence priority and IS weights.

Port of ``r2d2dpg_tpu/ops/priority.py``: proportional prioritization with
importance weights ``w_i = (N * P(i))^-beta`` normalized by the batch max,
and R2D2's sequence priority ``eta * max|delta| + (1 - eta) * mean|delta|``.
"""

from __future__ import annotations

import numpy as np
import torch

# Keeps every stored sequence sampleable and priorities strictly positive.
PRIORITY_EPS = 1e-6


def sequence_priority(
    td: torch.Tensor, *, eta: float = 0.9, dim: int = -1
) -> torch.Tensor:
    """R2D2 eta-mix of max and mean absolute TD error along ``dim``."""
    abs_td = td.abs()
    return (
        eta * abs_td.amax(dim=dim)
        + (1.0 - eta) * abs_td.mean(dim=dim)
        + PRIORITY_EPS
    )


def importance_weights(
    probs: torch.Tensor, size: int, *, beta: float
) -> torch.Tensor:
    """Normalized IS weights ``(N * P(i))^-beta / max_j w_j`` over the batch.

    Args:
      probs: ``[B]`` probabilities with which each sampled item was drawn.
      size: current number of valid items in the buffer (N).
      beta: IS exponent (0 = no correction, 1 = full).
    """
    size_f = max(float(size), 1.0)
    w = (size_f * probs.clamp_min(1e-12)) ** (-beta)
    return w / w.max().clamp_min(1e-12)


def anneal_beta(step: int, *, beta0: float, steps: int) -> float:
    """Linear beta annealing beta0 -> 1 over ``steps`` learner updates.

    Evaluated in float32, as the JAX reference does, so the exponent handed to
    ``importance_weights`` is the same number on both sides.
    """
    frac = np.clip(np.float32(step) / np.float32(max(steps, 1)), 0.0, 1.0)
    return float(np.float32(beta0) + np.float32(1.0 - beta0) * np.float32(frac))
