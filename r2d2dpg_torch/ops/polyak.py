"""Target-network soft (Polyak) update over parameter dicts.

Port of ``r2d2dpg_tpu/ops/polyak.py``.  Both functions return new tensors
and leave their inputs untouched, so a params dict held elsewhere (a
behaviour snapshot) stays a snapshot.
"""

from __future__ import annotations

from typing import Dict

import torch

Params = Dict[str, torch.Tensor]


def polyak_update(online: Params, target: Params, tau: float) -> Params:
    """``target <- tau * online + (1 - tau) * target``."""
    return {k: tau * online[k] + (1.0 - tau) * target[k] for k in target}


def hard_update(online: Params, target: Params) -> Params:
    """Target becomes a copy of the online params."""
    del target
    return {k: v.clone() for k, v in online.items()}
