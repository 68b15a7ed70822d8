"""The served sessions' actions, recomputed: the actor rolled over each
lane's observations ``[S, T, ...]`` from a zero carry, which ``reset``
zeroes again at the first request of every session."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from perfbench.reference.nets import Params, Precision, actor_step, full_precision


@torch.no_grad()
def actions(params: Params, obs: np.ndarray, reset: np.ndarray, precision: str,
            device) -> np.ndarray:
    full_precision()
    pr = Precision(precision)
    o = torch.as_tensor(obs, device=device)
    r = torch.as_tensor(reset, device=device)
    hidden = params["core.cell.wh"].shape[1]
    carry = (torch.zeros(o.shape[0], hidden, device=device),
             torch.zeros(o.shape[0], hidden, device=device))
    out: List[torch.Tensor] = []
    for t in range(o.shape[1]):
        a, carry = actor_step(params, o[:, t], carry, r[:, t], pr)
        out.append(a)
    return torch.stack(out, 1).cpu().numpy()
