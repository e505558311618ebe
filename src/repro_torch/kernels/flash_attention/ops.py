"""Public wrapper: the model layout, and dispatch between the CUDA kernel
and the plain PyTorch version.

`flash_attention` is what the model's prefill attention runs through
with ``use_kernel=True``. The plain version is taken for one reason
only besides an explicit ``use_kernel=False``: the tensors lie on the
CPU. For CUDA tensors with ``use_kernel=True`` the kernel is launched or
the call raises; there is no fallback. Every launch adds one to
``counts.flash_attention`` when the caller hands in ``counts`` (a
`kernels.counts.KernelCounts`), so a run can show that it went through
the kernel; the module keeps no state of its own.
"""
from __future__ import annotations

import torch

from . import kernel as _kernel
from .ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    use_kernel: bool, counts=None) -> torch.Tensor:
    """q: [B, Sq, H, hd]; k, v: [B, Skv, K, hd] -> [B, Sq, H, hd].

    GQA: q head h reads kv head h // (H // K); K/V are never expanded on
    the kernel path."""
    _kernel.check_inputs(q, k, v, causal=causal, window=window)
    if not use_kernel or q.device.type == "cpu":
        B, Sq, H, hd = q.shape
        Skv, K = k.shape[1], k.shape[2]
        out = attention_ref(q.transpose(1, 2).reshape(B * H, Sq, hd),
                            k.transpose(1, 2).reshape(B * K, Skv, hd),
                            v.transpose(1, 2).reshape(B * K, Skv, hd),
                            causal=causal, window=window)
        return out.reshape(B, H, Sq, hd).transpose(1, 2)
    out = _kernel.flash_attention_cuda(q, k, v, window=window)
    if counts is not None:
        counts.flash_attention += 1
    return out
