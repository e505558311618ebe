"""Build, bind and launch the CUDA flash-attention kernel.

The source is `csrc/flash_attention.cu` (see its head note for what it
replaces and how it is laid out). It is compiled by `nvcc` for
``sm_90a`` at first use through `kernels.build` and bound with `ctypes`.
Nothing here runs at import, so hosts without a CUDA toolkit can import
the module.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from .. import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 80, 128)     # template instantiations in the source
DTYPES = (torch.float32, torch.bfloat16)


def load() -> ctypes.CDLL:
    """The kernel library, built on first use; raises
    `build.KernelCompileError` when it cannot be built."""
    lib = build.load_library("flash_attention", [SOURCE])
    if getattr(lib.flash_attention_launch, "argtypes", None) is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                               ctypes.c_float, i, p]
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_head_dim_supported.argtypes = [i]
        lib.flash_attention_head_dim_supported.restype = ctypes.c_int
    return lib


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool, window: int) -> None:
    """Validate the model-layout inputs: q [B, Sq, H, hd], k, v
    [B, Skv, K, hd], one float dtype, one device, contiguous, H % K == 0.
    Raises `TypeError` / `ValueError` on anything else."""
    if not causal:
        raise ValueError("only causal attention is supported (as in the "
                         "reference kernel)")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D [B, S, heads, hd], got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")
    B, Sq, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k, v must be [{B}, Skv, K, {hd}], got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if min(B, Sq, H, hd, k.shape[1], k.shape[2]) < 1 or H % k.shape[2]:
        raise ValueError(f"need H % K == 0 and non-empty shapes, got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         window: int = 0) -> torch.Tensor:
    """Launch the kernel on CUDA tensors in the model layout:
    q [B, Sq, H, hd], k, v [B, Skv, K, hd] -> [B, Sq, H, hd] in q's
    dtype. Causal; ``window`` > 0 adds a sliding window. Needs 16-byte
    aligned data (the bf16 kernel copies 16 bytes at a time). Launches on
    the current stream and does not synchronise."""
    check_inputs(q, k, v, causal=True, window=window)
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} has no kernel instantiation; "
                         f"supported: {HEAD_DIMS}")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    lib = load()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Skv, H, K, hd, window, 1.0 / math.sqrt(hd),
            int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError "
                           f"{err} (q {tuple(q.shape)}, k {tuple(k.shape)}, "
                           f"{q.dtype}, window={window})")
    return out
