"""Synthetic sharded input pipeline of the training path (NumPy only)."""
from .pipeline import DataPipeline, PipelineConfig, ShardStats, synth_batch

__all__ = ["DataPipeline", "PipelineConfig", "ShardStats", "synth_batch"]
