"""n-step TD targets and TD errors (plain functions on tensors).

Port of ``r2d2dpg_tpu/ops/returns.py``; the conventions are the same.  A
stored step ``t`` holds ``(obs_t, a_t, r_t, d_t, reset_t)``: ``d_t`` is the
continuation flag (0 when the episode terminated at ``t -> t+1``) and
``reset_t`` is 1 when ``obs_t`` begins a new episode.

Episode boundaries inside the n-step horizon:

- **Termination** (``d_{t+k} = 0``): reward ``r_{t+k}`` counts and the
  discount product cuts everything after it.
- **Truncation** (``reset_{t+k+1} = 1`` with ``d_{t+k} > 0``): the successor
  state was discarded by the auto-reset, so the horizon is shortened to
  bootstrap at ``q_{t+k}`` and the boundary-crossing reward is dropped.
"""

from __future__ import annotations

import torch


def n_step_targets(
    rewards: torch.Tensor,
    discounts: torch.Tensor,
    resets: torch.Tensor,
    bootstrap_q: torch.Tensor,
    *,
    n: int,
    gamma: float,
) -> torch.Tensor:
    """Boundary-aware n-step TD targets along the trailing time axis.

    Args:
      rewards, discounts, resets, bootstrap_q: ``[..., U + n]``.
      n: max number of reward steps.
      gamma: discount factor.

    Returns:
      ``[..., U]`` targets for the first ``U = T - n`` positions.
    """
    T = rewards.shape[-1]
    U = T - n
    if U <= 0:
        raise ValueError(f"sequence time axis {T} must exceed n_step {n}")

    def tslice(x, k):
        return x[..., k : k + U]

    acc = torch.zeros_like(tslice(rewards, 0))
    cont = torch.ones_like(acc)  # discount product (termination cut)
    live = torch.ones_like(acc)  # 1 until any episode boundary is crossed
    y = tslice(bootstrap_q, 0)  # horizon-0 fallback (immediate truncation)
    for k in range(n):
        d_k = tslice(discounts, k)
        next_reset = tslice(resets, k + 1)
        is_trunc = next_reset * (d_k > 0.0).to(d_k.dtype)
        valid = (live * (1.0 - is_trunc)) > 0
        acc_ext = acc + (gamma**k) * cont * tslice(rewards, k)
        cont_ext = cont * d_k
        y_ext = acc_ext + (gamma ** (k + 1)) * cont_ext * tslice(bootstrap_q, k + 1)
        y = torch.where(valid, y_ext, y)
        acc = torch.where(valid, acc_ext, acc)
        cont = torch.where(valid, cont_ext, cont)
        live = live * (1.0 - next_reset)
    return y


def td_errors(q_values: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-step TD errors ``delta_t = y_t - Q(s_t, a_t)``."""
    return targets - q_values


def huber(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """Huber loss element-wise."""
    abs_x = x.abs()
    quad = torch.clamp(abs_x, max=delta)
    return 0.5 * quad**2 + delta * (abs_x - quad)
