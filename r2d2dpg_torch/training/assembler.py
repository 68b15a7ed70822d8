"""Sliding-window sequence assembler.

Port of ``r2d2dpg_tpu/training/assembler.py``.  The window is a
struct-of-arrays ``[num_envs, L, ...]`` buffer; each collect phase shifts in
``stride`` fresh steps and the whole window is emitted as ``num_envs``
sequences.  Episode boundaries ride inside the sequence as ``reset`` flags.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import torch

from r2d2dpg_torch.replay.arena import SequenceBatch
from r2d2dpg_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class StepRecord:
    """Per-step data recorded by the actor phase (leaves ``[..., E, ...]``).

    ``carries`` holds each net's recurrent state BEFORE processing ``obs``;
    at emission, position 0's carries become the stored initial state.
    """

    obs: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    discount: torch.Tensor
    reset: torch.Tensor
    carries: Dict[str, Any]


def init_window(example: StepRecord, seq_len: int) -> StepRecord:
    """Zero window ``[E, L, ...]`` from a single-step example ``[E, ...]``."""
    return tree_map(
        lambda x: torch.zeros(
            x.shape[:1] + (seq_len,) + x.shape[1:], dtype=x.dtype, device=x.device
        ),
        example,
    )


def stack_steps(records: Sequence[StepRecord]) -> StepRecord:
    """Stack per-step records into one time-major record ``[S, E, ...]``."""
    return tree_map(lambda *xs: torch.stack(xs), *records)


def shift_in(window: StepRecord, fresh: StepRecord) -> StepRecord:
    """Append ``stride`` time-major fresh steps ``[S, E, ...]``, drop the oldest."""

    def upd(buf, new):
        new_bm = new.transpose(0, 1)  # [S, E, ...] -> [E, S, ...]
        return torch.cat([buf[:, new_bm.shape[1] :], new_bm], dim=1)

    return tree_map(upd, window, fresh)


def emit(window: StepRecord) -> SequenceBatch:
    """The current window as a batch of sequences (one per env lane)."""
    return SequenceBatch(
        obs=window.obs,
        action=window.action,
        reward=window.reward,
        discount=window.discount,
        reset=window.reset,
        carries=tree_map(lambda c: c[:, 0], window.carries),
    )
