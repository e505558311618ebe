"""Mamba2 SSD (state-space duality) scan for the model's prefill.

`ops.ssd` is the public entry, in the model layout (x [B, S, H, P],
dt [B, S, H], a [H], b, c [B, S, N]). On a CUDA tensor it launches the
hand-written Hopper kernel (`csrc/ssd.cu`, built and bound by
`kernel.py`); on a CPU tensor it runs the plain PyTorch version in
`ref.py`, the sequential recurrence.
"""
from .ops import ssd  # noqa: F401
from .ref import ssd_ref                                # noqa: F401
