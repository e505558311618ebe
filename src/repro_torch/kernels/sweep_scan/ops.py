"""Public wrapper: dispatch between the CUDA kernel and the plain
PyTorch version, with a launch counter.

`sweep_scan` is what `SweepEngine` runs its scan-mode buckets through
(behind the ``sim_engine`` knob). The plain version is taken for one
reason only besides an explicit ``use_kernel=False``: the tensors lie on
the CPU. For CUDA tensors with ``use_kernel=True`` the kernel is
launched or the call raises; there is no fallback from a failed build
or launch to the plain version. Every launch adds one to a plain
integer (`launch_count`), so a run can show that it went through the
kernel; the engine's `CacheStats.kernel_buckets` / ``kernel_fallbacks``
count the dispatch one level up.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import kernel as _kernel
from .kernel import MAX_SMEM_BYTES
from .ref import sweep_scan_ref

_launches = 0


def launch_count() -> int:
    """Kernel launches made through `sweep_scan` since the last reset."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def cuda_supported(device=None) -> bool:
    """Can `sweep_scan` take the kernel path for tensors on ``device``
    (default: the current CUDA device)? True exactly when the device is
    a CUDA device that is present; the engine resolves its
    ``sim_engine`` knob against this."""
    dev = torch.device("cuda" if device is None else device)
    return dev.type == "cuda" and torch.cuda.is_available()


def sweep_scan(res: torch.Tensor, dur: torch.Tensor, lag: torch.Tensor,
               deps: torch.Tensor, *, n_resources: int, use_kernel: bool,
               max_smem_bytes: int = MAX_SMEM_BYTES
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched FIFO scan: res i32[C, N], dur/lag f64[C, N],
    deps i32[C, N, MAXD] -> (makespan f64[C], end f64[C, N]).

    ``use_kernel`` is decided by the caller; both paths are element-wise
    equal. ``max_smem_bytes`` is passed to the kernel launch (see
    `kernel.sweep_scan_cuda`)."""
    _kernel.check_inputs(res, dur, lag, deps, n_resources)
    if not use_kernel or res.device.type == "cpu":
        return sweep_scan_ref(res, dur, lag, deps, n_resources=n_resources)
    global _launches
    out = _kernel.sweep_scan_cuda(res, dur, lag, deps, n_resources=n_resources,
                                  max_smem_bytes=max_smem_bytes)
    _launches += 1
    return out
