"""Causal flash attention (sliding window, GQA) for the model's prefill.

`ops.flash_attention` is the public entry, in the model layout
[B, S, heads, hd]. On a CUDA tensor it launches the hand-written Hopper
kernel (`csrc/flash_attention.cu`, built and bound by `kernel.py`); on a
CPU tensor it runs the plain PyTorch version in `ref.py`.
"""
from .ops import flash_attention  # noqa: F401
from .ref import attention_ref                                     # noqa: F401
