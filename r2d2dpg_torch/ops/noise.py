"""Exploration noise: per-actor sigma ladder and Gaussian/OU processes.

Port of ``r2d2dpg_tpu/ops/noise.py``.  Each env lane ``i`` of ``N`` gets
its own noise scale (Ape-X's per-actor ladder): geometric
``sigma_max ** (1 + alpha * i / (N - 1))`` by default, linear or constant
on request.  The noise functions take an optional pre-drawn standard
normal, so a test can feed both packages the same numbers; without one
they draw from ``generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def sigma_ladder(
    num_actors: int,
    *,
    sigma_max: float = 0.4,
    alpha: float = 7.0,
    kind: str = "geometric",
    sigma_min: float = 0.05,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """Per-actor exploration scales, shape ``[num_actors]`` float32."""
    if num_actors < 1:
        raise ValueError("num_actors must be >= 1")
    i = torch.arange(num_actors, dtype=torch.float32, device=device)
    denom = max(num_actors - 1, 1)
    if kind == "geometric":
        return torch.pow(sigma_max, 1.0 + alpha * i / denom)
    if kind == "linear":
        if num_actors == 1:
            return torch.full((1,), sigma_max, device=device)
        return sigma_min + (sigma_max - sigma_min) * (1.0 - i / denom)
    if kind == "constant":
        return torch.full((num_actors,), sigma_max, device=device)
    raise ValueError(f"unknown ladder kind: {kind}")


def _standard_normal(like, normal, generator):
    if normal is not None:
        return normal
    return torch.randn(
        like.shape, generator=generator, dtype=like.dtype, device=like.device
    )


def gaussian_noise(
    action: torch.Tensor,
    sigma: torch.Tensor,
    *,
    normal: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Additive Gaussian noise; ``sigma`` broadcasts over the action axis."""
    return sigma[..., None] * _standard_normal(action, normal, generator)


def ou_step(
    noise_state: torch.Tensor,
    sigma: torch.Tensor,
    *,
    theta: float = 0.15,
    dt: float = 1e-2,
    normal: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """One Ornstein-Uhlenbeck step; returns the new noise state (== the noise).

    ``x' = x - theta*x*dt + sigma*sqrt(dt)*N(0,1)``; the caller zeroes the
    state at episode boundaries.
    """
    drift = -theta * noise_state * dt
    diffusion = (
        sigma[..., None]
        * math.sqrt(dt)
        * _standard_normal(noise_state, normal, generator)
    )
    return noise_state + drift + diffusion
