"""Plain float32 actor and critic of the R2D2-DPG recipe, on parameter dicts.

Written from the published recipe (R2D2: Kapturowski et al. 2019; DDPG:
Lillicrap et al. 2015), not from the measured program:

- torso: one ReLU dense layer over flat observations, or the Nature-DQN
  stack (32x8/4, 64x4/2, 64x3/1 VALID convolutions with ReLU, then a
  ReLU dense layer) over ``[..., H, W, C]`` uint8 frames scaled by 1/255;
- core: an LSTM cell, gates i, f, g, o, ``z = h Wh^T + bh + x Wi^T``, its
  carry zeroed where ``reset`` is set before the cell runs;
- actor head: ``tanh`` of a dense layer; critic: the action joins the
  torso output in the ``mix`` dense layer (ReLU) before the core, and a
  dense head gives Q.

Parameter keys follow the program's module paths, so the benchmark can
hand one weight dict to both sides.  Every product runs at the shapes a
step of the recipe has (one time step of a batch), so that the reference
and the program round alike where they compute alike.

``precision``: ``"float32"`` (TF32 off) or ``"tf32"``, which rounds both
operands of every matmul and convolution to TF32's 10-bit mantissa before
a float32 product: the control of the correctness check, the same on
every device.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
CONV_LAYERS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))  # (features, kernel, stride)


def full_precision() -> None:
    """float32 products stay float32 (no TF32) on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest TF32 value (10 mantissa bits), ties away;
    the gradient passes straight through."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach() if x.requires_grad else rounded


class Precision:
    def __init__(self, name: str = "float32"):
        if name not in ("float32", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.round = to_tf32 if name == "tf32" else (lambda t: t)

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w^T``."""
        return torch.matmul(self.round(x), self.round(w).t())

    def conv(self, x, w, stride):
        return F.conv2d(self.round(x), self.round(w), None, stride)


def conv_out_hw(h: int, w: int) -> Tuple[int, int]:
    for _, k, s in CONV_LAYERS:
        h, w = (h - k) // s + 1, (w - k) // s + 1
    return h, w


def param_shapes(obs_shape: Sequence[int], action_dim: int, hidden: int,
                 pixels: bool) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """``{"actor": {key: shape}, "critic": {...}}`` of the recipe's nets."""
    def torso():
        if not pixels:
            return {"torso.layers.0.weight": (hidden, obs_shape[0]),
                    "torso.layers.0.bias": (hidden,)}
        out, c = {}, obs_shape[2]
        for i, (f, k, _) in enumerate(CONV_LAYERS):
            out[f"torso.convs.{i}.weight"] = (f, c, k, k)
            out[f"torso.convs.{i}.bias"] = (f,)
            c = f
        h, w = conv_out_hw(obs_shape[0], obs_shape[1])
        out["torso.dense.weight"] = (hidden, h * w * c)
        out["torso.dense.bias"] = (hidden,)
        return out

    core = {"core.cell.wi": (4 * hidden, hidden), "core.cell.wh": (4 * hidden, hidden),
            "core.cell.bh": (4 * hidden,)}
    actor = {**torso(), **core, "head.weight": (action_dim, hidden),
             "head.bias": (action_dim,)}
    critic = {**torso(), "mix.weight": (hidden, hidden + action_dim),
              "mix.bias": (hidden,), **core, "head.weight": (1, hidden),
              "head.bias": (1,)}
    return {"actor": actor, "critic": critic}


def torso(p: Params, obs: torch.Tensor, pr: Precision) -> torch.Tensor:
    """``[N, ...obs]`` -> ``[N, hidden]``."""
    dtype = p["head.weight"].dtype  # float32; float64 for the exact priorities
    if "torso.dense.weight" not in p:
        x = obs.to(dtype)
        return torch.relu(pr.mm(x, p["torso.layers.0.weight"]) + p["torso.layers.0.bias"])
    x = obs.to(dtype)
    if obs.dtype == torch.uint8:
        x = x / 255.0
    x = x.permute(0, 3, 1, 2)
    for i, (_, _, s) in enumerate(CONV_LAYERS):
        b = p[f"torso.convs.{i}.bias"]
        x = torch.relu(pr.conv(x, p[f"torso.convs.{i}.weight"], s) + b[:, None, None])
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # [h, w, c] order
    return torch.relu(pr.mm(x, p["torso.dense.weight"]) + p["torso.dense.bias"])


def lstm(p: Params, x, carry, reset, pr: Precision):
    """One LSTM step: ``(c, h)`` zeroed where ``reset``; returns ``(h, (c, h))``."""
    c, h = carry
    keep = (reset <= 0).to(c.dtype)[:, None]
    c, h = c * keep, h * keep
    z = pr.mm(h, p["core.cell.wh"]) + p["core.cell.bh"] + pr.mm(x, p["core.cell.wi"])
    i, f, g, o = z.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, (c, h)


def actor_step(p: Params, obs, carry, reset, pr: Precision):
    """``(action [N, A], carry)``."""
    y, carry = lstm(p, torso(p, obs, pr), carry, reset, pr)
    return torch.tanh(pr.mm(y, p["head.weight"]) + p["head.bias"]), carry


def critic_step(p: Params, obs, action, carry, reset, pr: Precision):
    """``(q [N], carry)``."""
    x = torch.cat([torso(p, obs, pr), action], dim=-1)
    m = torch.relu(pr.mm(x, p["mix.weight"]) + p["mix.bias"])
    y, carry = lstm(p, m, carry, reset, pr)
    return (pr.mm(y, p["head.weight"]) + p["head.bias"])[:, 0], carry
