"""Grouped expert SwiGLU FFN for the MoE layer (prefill and decode).

`ops.expert_ffn` is the public entry: x [G*E, C, d] (capacity buffers),
wg, wu [E, d, f], wd [E, f, d]. On a CUDA tensor it launches the
hand-written Hopper kernel (`csrc/moe_gmm.cu`, built and bound by
`kernel.py`); on a CPU tensor it runs the plain PyTorch version in
`ref.py`.
"""
from .ops import expert_ffn  # noqa: F401
from .ref import expert_ffn_ref                                # noqa: F401
