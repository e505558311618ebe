"""Checkpointing over an intermediate storage layer: the store and its
manifest-committed checkpoints, and the planner through which the
framework side reaches the predictor."""
from .planner import CheckpointPlan, plan_checkpoint
from .store import CheckpointManager, IntermediateStore

__all__ = ["CheckpointPlan", "plan_checkpoint", "CheckpointManager",
           "IntermediateStore"]
