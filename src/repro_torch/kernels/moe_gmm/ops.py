"""Public wrapper: dispatch between the CUDA kernel and the plain PyTorch
version.

`expert_ffn` is what the MoE layer runs its capacity buffers through
with ``use_kernel=True``. The plain version is taken for one reason only
besides an explicit ``use_kernel=False``: the tensors lie on the CPU.
For CUDA tensors with ``use_kernel=True`` the kernel is launched or the
call raises; there is no fallback. Every launch adds one to
``counts.moe_gmm`` when the caller hands in ``counts`` (a
`kernels.counts.KernelCounts`), so a run can show that it went through
the kernel; the module keeps no state of its own.
"""
from __future__ import annotations

import torch

from . import kernel as _kernel
from .ref import expert_ffn_ref


def expert_ffn(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
               wd: torch.Tensor, *, use_kernel: bool, counts=None
               ) -> torch.Tensor:
    """x: [G*E, C, d]; wg, wu: [E, d, f]; wd: [E, f, d] -> [G*E, C, d] in
    x's dtype: ``(silu(x wg[e]) * (x wu[e])) wd[e]`` with e = group % E,
    summed in f32."""
    _kernel.check_inputs(x, wg, wu, wd)
    if not use_kernel or x.device.type == "cpu":
        return expert_ffn_ref(x, wg, wu, wd)
    out = _kernel.moe_gmm_cuda(x, wg, wu, wd)
    if counts is not None:
        counts.moe_gmm += 1
    return out
