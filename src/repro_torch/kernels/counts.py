"""Launch counts of the model path's kernels, owned by the caller.

A `KernelCounts` is what the model entry points (`forward`,
`decode_step`, `loss_fn` and the step factories) take as ``counts=`` and
hand down to `flash_attention`, `ssd` and `expert_ffn`: each wrapper adds
one to its field where it launches its kernel, and nowhere else. A call
made without ``counts`` is counted nowhere, as K1's launches count only
into the `CacheStats` a sweep session hands in. The kernel packages keep
no state of their own; a new `KernelCounts` is a reset.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class KernelCounts:
    flash_attention: int = 0
    ssd: int = 0
    moe_gmm: int = 0
