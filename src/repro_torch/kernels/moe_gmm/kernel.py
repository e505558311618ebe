"""Build, bind and launch the CUDA grouped expert-FFN kernel.

The source is `csrc/moe_gmm.cu` (see its head note for what it replaces
and how it is laid out). It is compiled by `nvcc` for ``sm_90a`` at
first use through `kernels.build` and bound with `ctypes`. Nothing here
runs at import, so hosts without a CUDA toolkit can import the module.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "moe_gmm.cu"
DTYPES = (torch.float32, torch.bfloat16)
MAX_GROUPS = 65535          # G*E rides on the grid's z axis


def load() -> ctypes.CDLL:
    """The kernel library, built on first use; raises
    `build.KernelCompileError` when it cannot be built."""
    lib = build.load_library("moe_gmm", [SOURCE])
    if getattr(lib.moe_gmm_launch, "argtypes", None) is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.moe_gmm_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.moe_gmm_launch.restype = ctypes.c_int
    return lib


def check_inputs(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                 wd: torch.Tensor) -> None:
    """Validate x [G*E, C, d], wg, wu [E, d, f], wd [E, f, d]: one float
    dtype, one device, contiguous, G*E a multiple of E. Raises
    `TypeError` / `ValueError` on anything else."""
    for name, t in (("x", x), ("wg", wg), ("wu", wu), ("wd", wd)):
        if t.dtype not in DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
        if t.dim() != 3:
            raise ValueError(f"{name} must be 3-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} lies on {t.device}, x on {x.device}")
    GE, C, d = x.shape
    E, _, f = wg.shape
    if wg.shape != (E, d, f) or wu.shape != (E, d, f) or wd.shape != (E, f, d):
        raise ValueError(f"need wg, wu [E, {d}, f] and wd [E, f, {d}], got "
                         f"{tuple(wg.shape)}, {tuple(wu.shape)}, "
                         f"{tuple(wd.shape)}")
    if min(GE, C, d, E, f) < 1 or GE % E:
        raise ValueError(f"need non-empty shapes and G*E % E == 0, got x "
                         f"{tuple(x.shape)}, E = {E}")


def moe_gmm_cuda(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                 wd: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: x [G*E, C, d], wg, wu
    [E, d, f], wd [E, f, d] -> [G*E, C, d] in x's dtype. Needs d and f
    to be multiples of 8 and 16-byte aligned data. bf16 allocates an act
    buffer [G*E, C, f] between its two GEMMs. Launches on the current
    stream and does not synchronise."""
    check_inputs(x, wg, wu, wd)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gmm_cuda needs CUDA tensors, got {x.device}")
    GE, C, d = x.shape
    E, _, f = wg.shape
    if d % 8 or f % 8:
        raise ValueError(f"the kernel copies 16 bytes at a time: d and f "
                         f"must be multiples of 8, got d={d}, f={f}")
    if GE > MAX_GROUPS:
        raise ValueError(f"G*E = {GE} exceeds {MAX_GROUPS}")
    for name, t in (("x", x), ("wg", wg), ("wu", wu), ("wd", wd)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    lib = load()
    bf16 = x.dtype == torch.bfloat16
    out = torch.empty_like(x)
    # bf16: silu(x wg) * (x wu), rounded once, between the two GEMMs; the
    # f32 kernel adds into `out` and takes no scratch
    act = torch.empty((GE, C, f), dtype=x.dtype, device=x.device) \
        if bf16 else out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.moe_gmm_launch(x.data_ptr(), wg.data_ptr(), wu.data_ptr(),
                                 wd.data_ptr(), out.data_ptr(), act.data_ptr(),
                                 GE, E, C, d, f, int(bf16), stream)
    if err != 0:
        raise RuntimeError(f"moe_gmm kernel launch failed: cudaError {err} "
                           f"(x {tuple(x.shape)}, wg {tuple(wg.shape)}, "
                           f"{x.dtype})")
    return out
