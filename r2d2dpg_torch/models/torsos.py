"""Observation torsos (MLP, pixel CNN) and the dense layer and inits the nets share.

Port of ``r2d2dpg_tpu/models/torsos.py``.  Inits follow the DDPG
convention of the JAX package: fan-in uniform hidden kernels, ``U(±3e-3)``
heads and ZERO biases (torch ``nn.Linear``'s default bias init differs, so
the port has its own ``Dense``); convolutions keep flax ``Conv``'s
lecun-normal kernels and zero biases.

``Dense`` keeps torch's ``weight [out, in]`` layout (the flax ``kernel``
transposed) and computes ``x @ weight.T + bias`` with ``matmul``, which
broadcasts: a weight stacked on a leading ensemble axis ``[E, out, in]``
applies E nets at once (the port's stand-in for ``jax.vmap`` over params).

``dtype`` is the compute type, as flax's ``dtype``: under ``bfloat16`` a
layer casts its input and its float32 params to bf16 on every call, so the
product and the bias join round to bf16 (``float32`` leaves the layer as it
was, with no cast).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
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
    """flax/JAX ``lecun_normal``: truncated normal (±2 std), variance 1/fan_in.

    The fan-in is every axis but the first: ``in`` for a Dense ``[out, in]``,
    ``in * kH * kW`` for a conv ``[out, in, kH, kW]`` (flax's HWIO kernel
    has the same fan-in).
    """

    def init(w: torch.Tensor, generator=None) -> None:
        # JAX rescales so the TRUNCATED distribution has variance 1/fan_in.
        std = math.sqrt(1.0 / math.prod(w.shape[1:])) / 0.87962566103423978
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)

    return init


def orthogonal() -> Init:
    def init(w: torch.Tensor, generator=None) -> None:
        nn.init.orthogonal_(w, generator=generator)

    return init


def dense(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    dtype: torch.dtype = torch.float32,
):
    """``x @ weight.T + bias`` in ``dtype``, broadcasting a leading ensemble axis."""
    if dtype != torch.float32:
        x, weight = x.to(dtype), weight.to(dtype)
        bias = None if bias is None else bias.to(dtype)
    y = torch.matmul(x, weight.transpose(-1, -2))
    if bias is not None:
        y = y + bias.unsqueeze(-2)
    return y


class Dense(nn.Module):
    """Affine layer with an explicit kernel init and a zero bias."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        kernel_init: Init,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.kernel_init = kernel_init
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.kernel_init(self.weight, generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias, self.dtype)


class MLPTorso(nn.Module):
    """ReLU MLP over flat observations."""

    def __init__(
        self,
        in_features: int,
        layer_sizes: Sequence[int] = (256,),
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        sizes = [in_features, *layer_sizes]
        self.layers = nn.ModuleList(
            Dense(a, b, fan_in_uniform(), dtype) for a, b in zip(sizes[:-1], sizes[1:])
        )

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs.to(self.dtype)
        for layer in self.layers:
            x = torch.relu(layer(x))
        return x


# Nature-DQN stack: (features, kernel, stride), VALID padding.
CONV_LAYERS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))


class Conv(nn.Module):
    """Parameters of one VALID conv: ``weight [out, in, k, k]``, zero ``bias``.

    flax ``Conv`` defaults: lecun-normal kernel over the fan-in ``in*k*k``.
    ``ConvTorso`` runs the stack, so this module has no ``forward``.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            lecun_normal()(self.weight, generator)
            self.bias.zero_()


def conv_output_hw(height: int, width: int) -> Tuple[int, int]:
    """Spatial size after ``CONV_LAYERS`` (VALID: ``(n - k) // s + 1``)."""
    for _, k, s in CONV_LAYERS:
        height, width = (height - k) // s + 1, (width - k) // s + 1
    if height < 1 or width < 1:
        raise ValueError("frame too small for the conv stack (36x36 is the least)")
    return height, width


class ConvTorso(nn.Module):
    """Nature-DQN CNN over pixel observations ``[..., H, W, C]`` (uint8 or float).

    The public layout is NHWC, as in JAX; the stack runs ``conv2d`` in NCHW
    and permutes back to NHWC before the flatten, so the flattened features
    come in flax's ``[h, w, c]`` order and the Dense after the convs takes
    the converted flax kernel as it is.  A uint8 frame is divided by 255.

    Ensembles: with conv weights stacked on a leading axis E
    (``[E, out, in, k, k]``), the stack runs as ONE grouped convolution per
    layer: the input frame is repeated E times along channels and
    ``groups=E`` keeps the members apart, so every member sees the same
    frame.  The output then carries the ensemble axis first, ``[E, ..., out]``,
    as the Dense layers' broadcasting does.
    """

    def __init__(
        self,
        obs_shape: Sequence[int],
        out_size: int = 256,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        height, width, channels = obs_shape
        self.dtype = dtype
        convs = []
        for features, kernel, stride in CONV_LAYERS:
            convs.append(Conv(channels, features, kernel, stride))
            channels = features
        self.convs = nn.ModuleList(convs)
        h, w = conv_output_hw(height, width)
        self.dense = Dense(h * w * channels, out_size, fan_in_uniform(), dtype)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        lead, (height, width, channels) = obs.shape[:-3], obs.shape[-3:]
        x = obs.to(self.dtype)
        if obs.dtype == torch.uint8:
            x = x / 255.0
        x = x.reshape(-1, height, width, channels).permute(0, 3, 1, 2)
        ens = self.convs[0].weight.shape[:-4]  # () or (E,)
        groups = ens[0] if ens else 1
        if ens:
            x = x.repeat(1, groups, 1, 1)  # [N, E*C, H, W]: member-major channels
        for conv in self.convs:
            weight = conv.weight.reshape(-1, *conv.weight.shape[-3:])
            bias = conv.bias.reshape(-1).to(self.dtype)
            y = F.conv2d(x, weight.to(self.dtype), None, conv.stride, groups=groups)
            x = torch.relu(y + bias[:, None, None])
        n, _, h, w = x.shape
        if ens:  # [N, E*O, h, w] -> [E, N, h, w, O]
            x = x.reshape(n, groups, -1, h, w).permute(1, 0, 3, 4, 2)
        else:  # [N, O, h, w] -> [N, h, w, O]
            x = x.permute(0, 2, 3, 1)
        x = x.reshape(*ens, *lead, -1)
        return torch.relu(self.dense(x))
