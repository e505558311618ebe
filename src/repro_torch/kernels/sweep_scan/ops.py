"""Public wrapper: dispatch between the CUDA kernel and the plain
PyTorch version, with a launch counter owned by the caller.

`sweep_scan` is what `SweepEngine` runs its scan-mode buckets through
(behind the ``sim_engine`` knob). The plain version is taken for one
reason only besides an explicit ``use_kernel=False``: the tensors lie on
the CPU. For CUDA tensors with ``use_kernel=True`` the kernel is
launched or the call raises; there is no fallback from a failed build
or launch to the plain version. Every launch adds one to
``stats.kernel_launches`` when the caller hands in ``stats`` (the
engine's session-owned `CacheStats`, which also counts the dispatch one
level up in ``kernel_buckets`` / ``kernel_fallbacks``); the module keeps
no state of its own.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import kernel as _kernel
from .kernel import MAX_SMEM_BYTES
from .ref import sweep_scan_ref


def cuda_supported(device=None) -> bool:
    """Can `sweep_scan` take the kernel path for tensors on ``device``
    (default: the current CUDA device)? True exactly when the device is
    a CUDA device that is present; the engine resolves its
    ``sim_engine`` knob against this."""
    dev = torch.device("cuda" if device is None else device)
    return dev.type == "cuda" and torch.cuda.is_available()


def sweep_scan(res: torch.Tensor, dur: torch.Tensor, lag: torch.Tensor,
               deps: torch.Tensor, *, n_resources: int, use_kernel: bool,
               stats=None, max_smem_bytes: int = MAX_SMEM_BYTES
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched FIFO scan: res i32[C, N], dur/lag f[C, N] (f64 or f32,
    one type), deps i32[C, N, MAXD] -> (makespan f[C], end f[C, N]).

    ``use_kernel`` is decided by the caller; both paths are element-wise
    equal on every input (see `kernel.sweep_scan_cuda`). ``stats``, when
    given, is any object with an integer ``kernel_launches`` attribute:
    each kernel launch adds one to it, and nothing else does; a launch
    made without ``stats`` is counted nowhere. ``max_smem_bytes`` is
    passed to the kernel launch."""
    _kernel.check_inputs(res, dur, lag, deps, n_resources)
    if not use_kernel or res.device.type == "cpu":
        return sweep_scan_ref(res, dur, lag, deps, n_resources=n_resources)
    out = _kernel.sweep_scan_cuda(res, dur, lag, deps, n_resources=n_resources,
                                  max_smem_bytes=max_smem_bytes)
    if stats is not None:
        stats.kernel_launches += 1
    return out
