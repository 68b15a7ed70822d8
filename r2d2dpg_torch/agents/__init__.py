"""The R2D2-DPG learner."""

from r2d2dpg_torch.agents.ddpg import AdamState, AgentConfig, R2D2DPG, TrainState

__all__ = ["AdamState", "AgentConfig", "R2D2DPG", "TrainState"]
