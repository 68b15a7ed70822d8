"""Sequence assembler, draws, and the phase-locked trainer."""

from r2d2dpg_torch.training.assembler import StepRecord, emit, init_window, shift_in
from r2d2dpg_torch.training.draws import Draws, ReplayDraws
from r2d2dpg_torch.training.trainer import Trainer, TrainerConfig, TrainerState

__all__ = [
    "Draws",
    "ReplayDraws",
    "StepRecord",
    "Trainer",
    "TrainerConfig",
    "TrainerState",
    "emit",
    "init_window",
    "shift_in",
]
