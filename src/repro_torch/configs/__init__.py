"""Architecture registry: the 10 assigned configs, selectable by id.

Data only; `get(name)` gives field for field the same `ArchConfig` as
the reference's registry.
"""
from typing import Dict, List

from repro_torch.models.config import (ALL_SHAPES, DECODE_32K, LONG_500K,
                                       PREFILL_32K, TRAIN_4K, ArchConfig,
                                       ShapeConfig)

from .granite_3_2b import CONFIG as granite_3_2b
from .llava_next_34b import CONFIG as llava_next_34b
from .mamba2_1p3b import CONFIG as mamba2_1p3b
from .mixtral_8x22b import CONFIG as mixtral_8x22b
from .musicgen_medium import CONFIG as musicgen_medium
from .qwen1p5_32b import CONFIG as qwen1p5_32b
from .qwen2_72b import CONFIG as qwen2_72b
from .qwen2p5_14b import CONFIG as qwen2p5_14b
from .qwen3_moe_235b_a22b import CONFIG as qwen3_moe_235b_a22b
from .zamba2_2p7b import CONFIG as zamba2_2p7b

ARCHS: Dict[str, ArchConfig] = {c.name: c for c in [
    mamba2_1p3b, musicgen_medium, qwen2p5_14b, granite_3_2b, qwen2_72b,
    qwen1p5_32b, llava_next_34b, qwen3_moe_235b_a22b, mixtral_8x22b,
    zamba2_2p7b,
]}

__all__ = ["ALL_SHAPES", "ARCHS", "ArchConfig", "ShapeConfig", "cells", "get"]


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def cells(arch: ArchConfig) -> List[ShapeConfig]:
    """The shape cells that apply to this architecture. `long_500k` needs
    sub-quadratic attention and is left out for pure full-attention
    archs."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if arch.sub_quadratic:
        out.append(LONG_500K)
    return out
