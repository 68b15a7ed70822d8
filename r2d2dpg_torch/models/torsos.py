"""Observation torso (MLP) and the dense layer and inits the nets share.

Port of ``r2d2dpg_tpu/models/torsos.py``.  Inits follow the DDPG
convention of the JAX package: fan-in uniform hidden kernels, ``U(±3e-3)``
heads and ZERO biases (torch ``nn.Linear``'s default bias init differs, so
the port has its own ``Dense``).  ``ConvTorso`` (pixels) waits for a later
slice.

``Dense`` keeps torch's ``weight [out, in]`` layout (the flax ``kernel``
transposed) and computes ``x @ weight.T + bias`` with ``matmul``, which
broadcasts: a weight stacked on a leading ensemble axis ``[E, out, in]``
applies E nets at once (the port's stand-in for ``jax.vmap`` over params).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

Init = Callable[[torch.Tensor, Optional[torch.Generator]], None]


def fan_in_uniform() -> Init:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) — the canonical DDPG hidden init."""

    def init(w: torch.Tensor, generator=None) -> None:
        bound = 1.0 / math.sqrt(w.shape[-1])
        nn.init.uniform_(w, -bound, bound, generator=generator)

    return init


def symmetric_uniform(scale: float) -> Init:
    """U(-scale, scale) — the canonical DDPG final-layer init (3e-3)."""

    def init(w: torch.Tensor, generator=None) -> None:
        nn.init.uniform_(w, -scale, scale, generator=generator)

    return init


def lecun_normal() -> Init:
    """flax/JAX ``lecun_normal``: truncated normal (±2 std), variance 1/fan_in."""

    def init(w: torch.Tensor, generator=None) -> None:
        # JAX rescales so the TRUNCATED distribution has variance 1/fan_in.
        std = math.sqrt(1.0 / w.shape[-1]) / 0.87962566103423978
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)

    return init


def orthogonal() -> Init:
    def init(w: torch.Tensor, generator=None) -> None:
        nn.init.orthogonal_(w, generator=generator)

    return init


def dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]):
    """``x @ weight.T + bias``, broadcasting a leading ensemble axis."""
    y = torch.matmul(x, weight.transpose(-1, -2))
    if bias is not None:
        y = y + bias.unsqueeze(-2)
    return y


class Dense(nn.Module):
    """Affine layer with an explicit kernel init and a zero bias."""

    def __init__(self, in_features: int, out_features: int, kernel_init: Init):
        super().__init__()
        self.kernel_init = kernel_init
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.kernel_init(self.weight, generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias)


class MLPTorso(nn.Module):
    """ReLU MLP over flat observations."""

    def __init__(self, in_features: int, layer_sizes: Sequence[int] = (256,)):
        super().__init__()
        sizes = [in_features, *layer_sizes]
        self.layers = nn.ModuleList(
            Dense(a, b, fan_in_uniform()) for a, b in zip(sizes[:-1], sizes[1:])
        )

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs.to(torch.float32)
        for layer in self.layers:
            x = torch.relu(layer(x))
        return x
