"""Public wrapper: the model layout, dispatch between the CUDA kernel and
the plain PyTorch version, and a launch counter.

`ssd` is what the model's Mamba2 prefill runs through with
``use_kernel=True``. The plain version is taken for one reason only
besides an explicit ``use_kernel=False``: the tensors lie on the CPU.
For CUDA tensors with ``use_kernel=True`` the kernel is launched or the
call raises; there is no fallback. The kernel reads b and c per batch
row for every head, so nothing is broadcast per head on that path (the
plain version, a test oracle, does broadcast). Every launch adds one to
a plain integer (`launch_count`): one per `ssd` call, although a launch
is three CUDA kernels (chunk_state, state_pass, chunk_scan).
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import kernel as _kernel
from .ref import ssd_ref

_launches = 0


def launch_count() -> int:
    """Kernel launches made through `ssd` since the last reset."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor, *, chunk: int = 128, use_kernel: bool
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model layout: x [B,S,H,P]; dt [B,S,H]; a [H]; b, c [B,S,N].
    Returns (y [B,S,H,P], h_final [B,H,N,P])."""
    B, S, H, P, N, _L = _kernel.check_inputs(x, dt, a, b, c, chunk)
    if not use_kernel or x.device.type == "cpu":
        y, h = ssd_ref(x.transpose(1, 2).reshape(B * H, S, P),
                       dt.transpose(1, 2).reshape(B * H, S),
                       a.repeat(B),
                       b[:, None].expand(B, H, S, N).reshape(B * H, S, N),
                       c[:, None].expand(B, H, S, N).reshape(B * H, S, N))
        return (y.reshape(B, H, S, P).transpose(1, 2),
                h.reshape(B, H, N, P))
    global _launches
    out = _kernel.ssd_cuda(x, dt, a, b, c, chunk=chunk)
    _launches += 1
    return out
