"""Public wrapper: the model layout, dispatch between the CUDA kernel and
the plain PyTorch version, and a launch counter.

`flash_attention` is what the model's prefill attention runs through
with ``use_kernel=True``. The plain version is taken for one reason
only besides an explicit ``use_kernel=False``: the tensors lie on the
CPU. For CUDA tensors with ``use_kernel=True`` the kernel is launched or
the call raises; there is no fallback. Every launch adds one to a plain
integer (`launch_count`), so a run can show that it went through the
kernel.
"""
from __future__ import annotations

import torch

from . import kernel as _kernel
from .ref import attention_ref

_launches = 0


def launch_count() -> int:
    """Kernel launches made through `flash_attention` since the last reset."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    use_kernel: bool) -> torch.Tensor:
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
    global _launches
    out = _kernel.flash_attention_cuda(q, k, v, window=window)
    _launches += 1
    return out
