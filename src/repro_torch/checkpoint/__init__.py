"""Checkpointing over an intermediate storage layer: the planner through
which the framework side reaches the predictor. The reference's
checkpoint store (`checkpoint/store.py`) is not ported yet."""
from .planner import CheckpointPlan, plan_checkpoint

__all__ = ["CheckpointPlan", "plan_checkpoint"]
