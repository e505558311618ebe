"""Build, bind and launch the CUDA sweep-scan kernel.

The source is `csrc/sweep_scan.cu` (see its head note for what it
replaces and how it is laid out). It is compiled by `nvcc` for
``sm_90a`` at first use through `kernels.build` and bound with `ctypes`
(`argtypes` set: pointers and the stream are ``c_void_p``). Nothing here
runs at import, so hosts without a CUDA toolkit can import the module.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from .. import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "sweep_scan.cu"
# -fmad=false: the kernel only adds and compares today; the flag keeps a
# later fused duration prologue (mul + add) from contracting unnoticed
EXTRA_FLAGS = ("-fmad=false",)
MAXD = 4
# most dynamic shared memory one block may ask for on Hopper (227 KB)
MAX_SMEM_BYTES = 232448


def load() -> ctypes.CDLL:
    """The kernel library, built on first use; raises
    `build.KernelCompileError` when it cannot be built."""
    lib = build.load_library("sweep_scan", [SOURCE], EXTRA_FLAGS)
    if getattr(lib.sweep_scan_launch, "argtypes", None) is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sweep_scan_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        lib.sweep_scan_launch.restype = ctypes.c_int
        lib.sweep_scan_base_smem_bytes.argtypes = [i]
        lib.sweep_scan_base_smem_bytes.restype = ctypes.c_int
        lib.sweep_scan_maxd.argtypes = []
        lib.sweep_scan_maxd.restype = ctypes.c_int
        if lib.sweep_scan_maxd() != MAXD:
            raise RuntimeError("sweep_scan library built for another MAXD")
    return lib


def check_inputs(res: torch.Tensor, dur: torch.Tensor, lag: torch.Tensor,
                 deps: torch.Tensor, n_resources: int) -> Tuple[int, int]:
    """Validate what the kernel takes; returns (C, N). Raises
    `TypeError` / `ValueError` on anything else."""
    for name, t, dt in (("res", res, torch.int32), ("dur", dur, torch.float64),
                        ("lag", lag, torch.float64), ("deps", deps, torch.int32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != res.device:
            raise ValueError(f"{name} lies on {t.device}, res on {res.device}")
    if res.dim() != 2:
        raise ValueError(f"res must be [C, N], got {tuple(res.shape)}")
    C, N = res.shape
    if dur.shape != (C, N) or lag.shape != (C, N):
        raise ValueError(f"dur/lag must be [{C}, {N}], got "
                         f"{tuple(dur.shape)} / {tuple(lag.shape)}")
    if deps.shape != (C, N, MAXD):
        raise ValueError(f"deps must be [{C}, {N}, {MAXD}], got "
                         f"{tuple(deps.shape)}")
    if C < 1 or N < 1 or n_resources < 1:
        raise ValueError("C, N and n_resources must be >= 1")
    return C, N


def sweep_scan_cuda(res: torch.Tensor, dur: torch.Tensor, lag: torch.Tensor,
                    deps: torch.Tensor, *, n_resources: int,
                    max_smem_bytes: int = MAX_SMEM_BYTES
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors: res i32[C, N], dur/lag
    f64[C, N], deps i32[C, N, MAXD] -> (makespan f64[C], end f64[C, N]).

    Indices are trusted, as in the reference: ``0 <= res < n_resources``
    and ``deps < N``. ``max_smem_bytes`` caps the dynamic shared memory
    one block may take: while ``end[N]`` fits under it the completion
    times live in shared memory, above it in the ``end`` output row in
    device memory (lower the cap to force that regime at a small N).
    Launches on the current stream and does not synchronise."""
    C, N = check_inputs(res, dur, lag, deps, n_resources)
    if res.device.type != "cuda":
        raise ValueError(f"sweep_scan_cuda needs CUDA tensors, got {res.device}")
    lib = load()
    base = lib.sweep_scan_base_smem_bytes(n_resources)
    if base > min(max_smem_bytes, MAX_SMEM_BYTES):
        raise ValueError(f"n_resources={n_resources} needs {base} bytes of "
                         f"shared memory, cap is {max_smem_bytes}")
    end_in_smem = base + 8 * N <= min(max_smem_bytes, MAX_SMEM_BYTES)
    makespan = torch.empty((C,), dtype=torch.float64, device=res.device)
    end = torch.empty((C, N), dtype=torch.float64, device=res.device)
    with torch.cuda.device(res.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sweep_scan_launch(res.data_ptr(), dur.data_ptr(),
                                    lag.data_ptr(), deps.data_ptr(),
                                    makespan.data_ptr(), end.data_ptr(),
                                    C, N, n_resources, int(end_in_smem),
                                    stream)
    if err != 0:
        raise RuntimeError(f"sweep_scan kernel launch failed: cudaError {err} "
                           f"(C={C}, N={N}, R={n_resources}, "
                           f"end_in_smem={end_in_smem})")
    return makespan, end
