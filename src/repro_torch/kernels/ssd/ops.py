"""Public wrapper: the model layout, and dispatch between the CUDA kernel
and the plain PyTorch version.

`ssd` is what the model's Mamba2 prefill runs through with
``use_kernel=True``. The plain version is taken for one reason only
besides an explicit ``use_kernel=False``: the tensors lie on the CPU.
For CUDA tensors with ``use_kernel=True`` the kernel is launched or the
call raises; there is no fallback. The kernel reads b and c per batch
row for every head, so nothing is broadcast per head on that path (the
plain version, a test oracle, does broadcast). Every launch adds one to
``counts.ssd`` when the caller hands in ``counts`` (a
`kernels.counts.KernelCounts`): one per `ssd` call, although a launch is
three CUDA kernels (chunk_state, state_pass, chunk_scan). The module
keeps no state of its own.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import kernel as _kernel
from .ref import ssd_ref


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor, *, chunk: int = 128, use_kernel: bool, counts=None
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
    out = _kernel.ssd_cuda(x, dt, a, b, c, chunk=chunk)
    if counts is not None:
        counts.ssd += 1
    return out
