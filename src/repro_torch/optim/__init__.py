"""Optimisers of the port: AdamW in the reference's functional form."""
from . import adamw
from .adamw import AdamWConfig, OptState

__all__ = ["adamw", "AdamWConfig", "OptState"]
