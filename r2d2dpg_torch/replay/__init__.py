"""Device-resident prioritized sequence replay."""

from r2d2dpg_torch.replay.arena import (
    PROVENANCE_ABSENT,
    ArenaState,
    ReplayArena,
    SampleResult,
    SequenceBatch,
    StagedSequences,
    stack_staged,
    staged_nbytes,
)

__all__ = [
    "PROVENANCE_ABSENT",
    "ArenaState",
    "ReplayArena",
    "SampleResult",
    "SequenceBatch",
    "StagedSequences",
    "stack_staged",
    "staged_nbytes",
]
