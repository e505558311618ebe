"""Build, bind and launch the CUDA sweep-scan kernel.

The source is `csrc/sweep_scan.cu` (see its head note for what it
replaces and how it is laid out), one schedule instantiated for f64 and
for f32 (``REPRO_SIM_X64=0``, the reference TPU kernel's mode). It is compiled by `nvcc` for
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
# op rows per staged tile, as in the source (the window the chain reads
# is the last two tiles); `load` checks it against the library
TILE_ROWS = 256
# most dynamic shared memory one block may ask for on Hopper (227 KB)
MAX_SMEM_BYTES = 232448


def load() -> ctypes.CDLL:
    """The kernel library, built on first use; raises
    `build.KernelCompileError` when it cannot be built."""
    lib = build.load_library("sweep_scan", [SOURCE], EXTRA_FLAGS)
    if getattr(lib.sweep_scan_launch, "argtypes", None) is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        for name in ("sweep_scan_launch", "sweep_scan_launch_f32"):
            getattr(lib, name).argtypes = [p, p, p, p, p, p, i, i, i, i, p]
            getattr(lib, name).restype = ctypes.c_int
        for name in ("sweep_scan_base_smem_bytes",
                     "sweep_scan_base_smem_bytes_f32"):
            getattr(lib, name).argtypes = [i]
            getattr(lib, name).restype = ctypes.c_int
        lib.sweep_scan_chain_probe.argtypes = [p, i, p]
        lib.sweep_scan_chain_probe.restype = ctypes.c_int
        for name in ("sweep_scan_maxd", "sweep_scan_tile_rows"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        if lib.sweep_scan_maxd() != MAXD:
            raise RuntimeError("sweep_scan library built for another MAXD")
        if lib.sweep_scan_tile_rows() != TILE_ROWS:
            raise RuntimeError("sweep_scan library built for another TILE_ROWS")
    return lib


# the float types the kernel is instantiated for
FLOAT_TYPES = (torch.float64, torch.float32)


def _suffix(dtype: torch.dtype) -> str:
    """The suffix of ``dtype``'s entry points in the library."""
    return "" if dtype == torch.float64 else "_f32"


def base_smem_bytes(n_resources: int, dtype: torch.dtype = torch.float64) -> int:
    """Shared-memory bytes one block needs besides ``end[N]`` (two
    staged tiles, avail, the window) for ``dtype``; builds the library."""
    return getattr(load(), "sweep_scan_base_smem_bytes" + _suffix(dtype))(
        n_resources)


def check_inputs(res: torch.Tensor, dur: torch.Tensor, lag: torch.Tensor,
                 deps: torch.Tensor, n_resources: int) -> Tuple[int, int]:
    """Validate what the kernel takes; returns (C, N). ``dur`` and
    ``lag`` are of one float type, f64 or f32. Raises `TypeError` /
    `ValueError` on anything else."""
    if dur.dtype not in FLOAT_TYPES:
        raise TypeError(f"dur must be float64 or float32, got {dur.dtype}")
    for name, t, dt in (("res", res, torch.int32), ("dur", dur, dur.dtype),
                        ("lag", lag, dur.dtype), ("deps", deps, torch.int32)):
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
    f[C, N], deps i32[C, N, MAXD] -> (makespan f[C], end f[C, N]), with
    f the float type of dur and lag (f64 or f32: the kernel's two
    instantiations).

    Indices are trusted, as in the reference: ``0 <= res < n_resources``
    and ``deps < N``. The result equals the plain version's to the bit on
    every ``dur`` and ``lag``, negative, infinite and NaN values included:
    a candidate whose values are all >= 0 takes the fast walk, any other
    the general one, which the kernel picks itself (see the head note of
    the source). ``max_smem_bytes`` caps the dynamic shared memory
    one block may take: while ``end[N]`` fits under it the completion
    times live in shared memory, above it in the ``end`` output row in
    device memory (lower the cap to force that regime at a small N).
    Launches on the current stream and does not synchronise."""
    C, N = check_inputs(res, dur, lag, deps, n_resources)
    if res.device.type != "cuda":
        raise ValueError(f"sweep_scan_cuda needs CUDA tensors, got {res.device}")
    lib = load()
    suffix = _suffix(dur.dtype)
    base = getattr(lib, "sweep_scan_base_smem_bytes" + suffix)(n_resources)
    if base > min(max_smem_bytes, MAX_SMEM_BYTES):
        raise ValueError(f"n_resources={n_resources} needs {base} bytes of "
                         f"shared memory, cap is {max_smem_bytes}")
    end_in_smem = (base + dur.element_size() * N
                   <= min(max_smem_bytes, MAX_SMEM_BYTES))
    makespan = torch.empty((C,), dtype=dur.dtype, device=res.device)
    end = torch.empty((C, N), dtype=dur.dtype, device=res.device)
    with torch.cuda.device(res.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, "sweep_scan_launch" + suffix)(
            res.data_ptr(), dur.data_ptr(), lag.data_ptr(), deps.data_ptr(),
            makespan.data_ptr(), end.data_ptr(), C, N, n_resources,
            int(end_in_smem), stream)
    if err != 0:
        raise RuntimeError(f"sweep_scan kernel launch failed: cudaError {err} "
                           f"(C={C}, N={N}, R={n_resources}, {dur.dtype}, "
                           f"end_in_smem={end_in_smem})")
    return makespan, end


def chain_probe(steps: int, device="cuda") -> torch.Tensor:
    """Launch the source's latency probe: one thread, ``steps`` dependent
    steps, each through a store and a load of shared memory (a chain that
    forwards nothing in registers). The kernel's chain forwards the row
    before in registers and skips that round trip, so the probe is a
    point of comparison, not a lower bound of its step. Returns its
    f64[1] output; time it by CUDA events. No path of the simulator runs
    it."""
    lib = load()
    out = torch.empty((1,), dtype=torch.float64, device=device)
    with torch.cuda.device(out.device):
        err = lib.sweep_scan_chain_probe(
            out.data_ptr(), steps, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sweep_scan chain probe failed: cudaError {err}")
    return out
